"""Drive the fusion_tpu_torch main paths once on one NVIDIA GPU and check them.

Run from the root of a checkout:  python3 chip_smoke.py [--profile]

Phases (each prints its result and wall time; any failed check exits 1):
  1. device   — requires CUDA; prints the card's name and power limit;
  2. build    — compiles the five kernel sources (csrc/maxsim.cu with K1,
                K1-v2 and K1-v1, dense_topk.cu with K2 and P3 at three doc
                blocks, scatter_score.cu with K3, P4 and P5, gather_rows.cu,
                attention.cu with the masked-attention kernel FA of the
                flash form, its residual mode and its backward FA-bwd (the
                dK/dV and dQ kernels); all but gather_rows.cu include the shared
                csrc/hopper.cuh), one nvcc each, all at once; prints their
                ptxas reports (registers, spills, shared memory, and the
                wgmma waits ptxas inserted);
     train    — training on the empty card, after the build: each family at
                its preset's shapes (DPR MNRL, LLeQA: batch 64, query and
                doc 512, one hard negative; SPLADE spladev2 (InfoNCE with
                in-batch negatives + FLOPS), LLeQA: batch 32, query 64, doc
                512; ColBERT CE, mMARCO: batch 128, query 32, doc 256, one
                negative; monoBERT BCE, LLeQA: batch 32, length 256),
                CamemBERT-base width, random weights, bf16 compute over f32
                master weights, remat on, AdamW: 1 warm-up and 3 timed steps
                (median ms/step, sequences/s, tokens/s, peak memory, the
                analytic model TFLOP per step (3 x forward) and hardware TFLOP
                (one more forward of the layers under remat), MFU against 989
                bf16 TFLOP/s) and one traced step; every loss finite;
     train_einsum_bf16 — the same with the attention in the einsum_bf16
                form (bf16-stored logits, the form JAX trains with): one
                warm-up and one timed step per family, no trace;
     train_agreement — the f32 train step on the card against the CPU at
                base width, 2 layers, batch 4, dropout 0, per family: loss
                within 1e-4, every gradient leaf within 1e-3 (norm-wise) and
                every param element within 0.2 lr after 3 AdamW steps; SPLADE,
                whose max pooling breaks near-ties either way, within 1e-2 on
                gradients and 5e-2 on each leaf's 3-step update;
     train_fit — full width, one repeated batch of 8 at a constant lr: the
                loss after 20 steps below step 1's, per family; the first
                step with dropout 0.1, remat on and off: equal losses,
                gradients within 2^-8 per leaf;
     attention_bwd — FA's residual mode and FA-bwd against their plain
                versions: one layer's doc call of the ColBERT bench step
                ([1024, 256, 12, 64] bf16), the packed rerank shape
                ([128, 256, 12, 64] with segments), a ragged L 37 with an
                all-pad row (bf16, f32) and packed f32 rows: the residual
                call's output bit-equal to the inference call's, m and l
                within 1e-5, dq / dk / dv within ATTN_BWD_TOL and
                bit-identical over 10 more launches; at the bench shape FA
                inference vs residual mode and FA-bwd vs plain in CUDA-event
                turns, scaled_dot_product_attention's backward (memory-
                efficient, the same boolean mask) and the bound;
     train_flash — the main path of this slice: tools/bench_colbert_train.py's
                step at full width (batch 128, 8-way, query 32, doc 256,
                CamemBERT-base, dropout 0, bf16 over f32 masters, remat,
                AdamW 5e-6) in the flash form, FA's and FA-bwd's counts set
                to 0 just before and read just after (72 and 36 a step), and
                in einsum_bf16: one warm-up, 3 timed steps and a traced one
                each, ms/step, useful and hardware MFU, peak memory, top
                device operations, every loss finite;
     train_agreement_flash — [train_agreement] in the flash form: the card
                runs FA and FA-bwd on their f32 path, the CPU their plain
                versions, under the same gates;
     hf_train — HF checkpoint directories written without transformers at
                CamemBERT-base width (a CamemBERT masked LM as
                model.safetensors, an X-MOD trunk with fr_XX / de_DE
                adapters as pytorch_model.bin; seeded random weights),
                loaded by ColBERT.from_pretrained_hf / from_xmod, taken to
                the flash form and trained 3 steps: losses finite, FA and
                FA-bwd launched once a layer a forward;
     cli_train — the CLI's dpr / splade / colbert / monobert (and monobert
                --backbone t5) at --tiny on a fixture it writes: --task
                train then --task test (ColBERT's through K1, its launches
                counted); each final/ reloaded encodes as the trained model
                does;
     train_parallel — data- and tensor-parallel training on two ranks
                sharing the card over gloo (children of this script): ColBERT
                flash on data = 2 and on model = 2 (6 heads a rank), DPR on
                data = 2, X-MOD SPLADE (xmod-base widths, the fr_XX adapter
                of fr_XX / en_XX) flash on model = 2 and the T5
                cross-encoder (--backbone t5 widths, its trunk whole on each
                rank) on model = 2; each an f32 pass at 2 layers held to one
                rank's step over the global batch (AGREE_GATES, two
                steps: the loss of each, the gradient, the parameters and
                the update after them) and a one-step bf16 pass at 4
                layers held to one rank's bf16 step
                (TRAIN_PARALLEL_BF16_GATES) and measured: ms a step,
                collective ms / MB / calls, peak memory, MFU, FA and FA-bwd
                launches (36 / 18 a step in flash); the ranks end with the
                same parameters;
     examples — fusion_tpu_torch/examples' quickstart, scale_serving and
                streaming_serving main() on the card, each with every count
                set to 0 just before and read just after, held to the same
                example on the CPU (a child of this script started before
                [train_parallel], whose host work overlaps the ranks'):
                quickstart (30 MNRL steps, the four-system searcher, the
                cross-encoder rerank of BM25's candidates, the metrics): K1
                launches (the ColBERT leg), the fused, candidate and
                reranked lists equal up to ties within 1e-5, the metrics
                equal; scale_serving (impact BM25 and SPLADE, compressed
                ColBERT with PLAID) over the CPU's PLAID index and IVF (its
                own build's centroid gap and IVF equality reported): K4
                launches (PLAID's rescore), the fused and the reloaded lists
                up to ties, the persistence round-trip identical as the
                example asserts; streaming_serving (segments behind the
                HTTP server): each of its four answers up to ties within
                2e-6, /healthz equal; seconds of each;
     tpu_tests — what tests_tpu/test_kernels_tpu.py holds on the TPU and no
                other phase holds on the card, at its shapes and
                tolerances: the blockwise top-k merge equal to one top-k;
                K2's binned top-1,000 against the exact int8 search over
                1,048,576 docs made on the card (mean overlap >= 0.97); K2's
                scale-0 rows losing to real rows of negative similarity,
                equal to the plain version; a 2-layer hidden-256 bf16 encoder
                in the flash form (FA) against einsum on real positions
                (atol 0.15, rtol 0.05, least cosine > 0.995); PLAID's gather
                and factored rescores through K4 against the plain gather
                (ids equal, scores within 1e-5); the launches of each;
     chunked_impact — tools/probe_chunked_impact.py at mMARCO's shape
                (8,912,896 docs, V 32,768, 272 chunks x cap 64, B 64): each
                stage's median ms (gather, the two sorts, the run totals,
                the full search in both sort forms at Kq 32 / 48 / 64; one
                JSON line); chunked_impact_search on the card against its
                CPU run at a small shape, both sort forms: ids up to ties,
                scores within 1e-5 of the row's largest;
  3. kernel   — K1 (MaxSim, the wgmma/TMA kernel) against its plain version
                at the serving shape (Ld 128, N 28,032, D 128, QL 64x32),
                bit-identical over 10 more launches, with its achieved
                TFLOP/s and share of its bound; then at a ragged shape, on a
                doc slice [333, 2333) of a 5,000-doc corpus (the view
                maxsim_search_tm passes), and at D 16 and D 96;
                |kernel - plain| <= 1e-2 + 1e-3 |plain| (bf16 products
                accumulated in f32 in another order); median CUDA-event
                times over 10 alternating runs;
     k1v1     — K1-v1 (the fused strict mode of csrc/maxsim.cu: the Ld max
                and the query-mask sum in one kernel) against its plain
                version at the MaxSim bench's headline shape (Q 32, Lq 32,
                N 28,032, Ld 128, D 128; bit-identical over 10 more launches,
                median times as K1 and the median device time) and at ragged
                ones (Lq 13 with Ld 131, Lq 48, Lq 128, Q 9, D 96, and N 1,001
                with its first and last docs fully masked), over a realistic
                mask (40-128 valid tokens per doc, every 997th doc fully
                masked, the last 3 tokens of every 3rd query masked): within
                K1's bound, and fully masked docs at -1e9 x the valid query
                tokens within it;
     k1v2     — K1-v2 (csrc/maxsim.cu, [QL, N] maxima) at the headline
                shape (bit-identical over 10 more launches in both modes)
                and at Ld 131 with tchunk 1, 2, 4 and 8 (the last ring stage
                reaches past Ld, where TMA's zero tokens must not enter the
                max): f32 within K1's bound, bf16 within one bf16 ulp of the
                plain version's rounded max; median times of the f32 mode;
     maxsim_fused_zeromask — the fused mode without a mask (zeroed
                tokens) against its plain version (qm @ the plain maxima) at
                the headline shape (bit-identical over 10 more launches, times
                as K1-v1) and at Lq 13 and 48;
     maxsim_variants — fusion_tpu_torch.tools.bench_maxsim.run at Q 32 and
                Q 64 (QL 1,024 and 2,048): every variant of the family (K1,
                K1-v1, the zeroed fused sum, K1-v2 f32 / bf16 / tchunk 2, 4,
                8) timed on the device and held to a blocked einsum reference,
                beside cuBLAS's matmul of the same FLOPs; the launch counts of
                K1-v1 and K1-v2 in the JSON record come from these two runs;
  4. k2       — K2 (int8 matmul + 16-doc binned max) against its plain version
                at the serving shape (Q 64, H 768, N 8,912,896, seeded int8
                rows, every 97th row dead) and a ragged one (Q 37, N 100,003
                padded to 2048-doc blocks with scale-0 rows, masked by
                n_docs): the -inf pattern equal, unpacked bin scores within
                1e-5 + 4e-6 |plain| (f32 sums of bf16 products in another
                order; the packing clears 4 mantissa bits, 2^-19 relative, on
                each side), and the in-bin offsets equal wherever the plain
                bin's two best scores differ by more than that; the ragged
                shape again at H 32 (the tiny scale-mode searcher's width);
                at the serving shape bit-identical over 10 more launches,
                with its achieved TB/s and share of its bound; median times
                over 10 alternating runs;
  5. k3       — K3 (the scatter scorer) likewise at the mMARCO serving shape
                (Q 64, Kq 64, docs_per_chunk 16,384, capc 32, C 544, V 32,005;
                10 more launches each within the tolerance of the first, with
                the median device time), a ragged one (Q 5, Kq 7,
                docs_per_chunk 2048, 3 chunks, sentinel-padded rows, an empty
                last chunk, pad query terms), the widest layout (Kq x capc
                = 8,192, dpc 2048) and the scale_build searcher's capc 74,
                whose rows are not 16-byte aligned: scores within 1e-6 + 1e-5
                |plain| (a doc's score is an f32 sum of at most Kq bf16
                values; the kernel's shared-memory atomics add them in
                another order on every run);
     p3       — P3 (K2 without the dead-row term, doc_block 4096) against its
                plain version on a synthesized mMARCO-size corpus (as K2's),
                and K2 at doc_block 4096 and 8192 on the same rows; P3 and K2
                at a ragged shape (Q 37, N 100,003 padded to 106,496, every
                13th row scale 0); K2's tolerance;
     p4, p5   — the pre-gathered scatter kernel, term-major (P4) and
                chunk-major (P5), against its plain version and against K3
                on the same index at the probe shape (Q 64, Kq 64, V 32,768,
                C 544, capc 32, dpc 16,384; 10 more launches each within the
                tolerance of the first, median times and device time, share
                of bound) and at K3's ragged, widest (Kq x capc = 8,192) and
                capc 74 shapes; K3's tolerance;
     probe_dense, probe_scatter_layout, probe_scatter_kernel — the three
                probe tools of fusion_tpu_torch/tools/ at the scripts'
                default mMARCO shapes, each with every launch count set to 0
                just before and read just after (K2 and P3; K3 and P4; K3
                and P5 must launch), each printing its JSON line; the
                layout probe's term-major search must match K3's (scores
                within 1e-5, top-10 overlap >= 0.99);
  6. k4       — K4 (the candidate-row gather) against its plain version
                (index_select per source) at a ragged shape (Q 5, K 37, five
                sources: int32 rows of 7, u8 rows of 3 bytes, f32 rows of 5,
                u8 [4, 32] rows and bool scalars; rows 0 and N-1 in every
                query): outputs byte-equal (torch.equal); the serving shape
                runs in phase 12;
  7. small    — a tiny searcher on the CPU (plain paths) and on the card
                (kernels) from the same seeds: per-system sorted scores agree
                within 1e-2 (f32 encoders, bf16/int8-stored corpora: an ulp
                of f32 difference can round a stored or query value to its
                bf16 neighbour, 2^-8 apart relatively);
  8. scale_small — the same for a tiny scale-mode searcher with an int8
                corpus (dense_impl="fused", splade_impl="scatter"), 1e-2;
  9. plaid_small — a tiny ColBERT searcher whose compressed index and IVF are
                built once on the CPU and copied to the card: PLAID (K4) and
                the exhaustive compressed search (K1) on the CPU (plain
                paths) and on the card agree within 1e-2 (sorted scores;
                plus 2^-8 |score| for the exhaustive search, whose queries
                are f32 on the CPU and bf16 on the card);
     rerank_small — a tiny BM25 + monoBERT searcher, packed and flat, on the
                CPU and on the card from the same seeds (f32): CPU vs card
                per stage and packed vs flat on the card, sorted scores
                within 1e-5 and equal ids at every rank whose score stands
                apart from the rest of its row;
 10. slice    — HybridSearcher.build at CamemBERT-base width (random seeded
                weights, bf16) over the synthetic zipf corpus of bench.py
                (seed 42, N 27,940, 40-160 words per doc; Lq 32, Ld 128), with
                a CamemBERT-base-width cross-encoder (max_length 256, rerank
                depth 100); the phases up to [rerank] serve it without the
                rerank stage (rerank_depth 0); search 192 queries at batch 64
                with every kernel launch count
                set to 0 just before and read just after; checks shapes, id
                range, finite non-increasing scores, that K1 ran, and that
                the ColBERT leg through the kernel matches the plain path on
                one batch (mean top-100 overlap >= 0.99); times warm batches
                with CUDA events and reads the peak device memory; then
     retrievers — each retriever's own search at top-1,000 over the first 64
                queries: ColBERT.search over the token index through its
                prepared (maxsim_search_tm) and doc-major (maxsim_search)
                branches (K1 launches in each), BiEncoder.search and
                SPLADE's search_sparse (over the pruned index built from the
                same docs), BM25Index.search_all (gather and matmul),
                search_dense, search_impact and search_sparse, each against
                the matching leg of search_systems or the same search on the
                CPU: top-100 overlap >= 0.99 each; then
     rerank   — the main path: the slice with the monoBERT stage over the
                fused top 100, packed (the default) and flat: 192 queries
                each, every launch count set to 0 just before the packed
                search and read just after (K1 once per batch, and the
                count the kernels line gives K1; FA once a layer and chunk
                scored, as the tracing counter attention.packed_kernel
                counts it, with no attention.packed_einsum call, and the
                count the kernels line gives FA), fused output checked, the
                same top-100 set per query in both; on one batch the two
                stages' logits (max gap reported), each within 0.04 of an
                f32 forward of the same weights, each
                stage's time, the packed plan's row fill, analytic FLOPs
                and the rate reached; warm timing and peak memory of each;
     rerank_packed_fa — the packed stage at the benchmark's shape (64
                queries' top 100 in rows 384 wide, 85 a chunk; CamemBERT-
                base, bf16, weights normal(0, 0.05)) with its attention on
                FA (the einsum form's packed rows on the card) against the
                einsum chain on the card and an f32 forward on the chain:
                perfbench's rerank readings of each beside its limits, FA
                once a layer and chunk, each path's stage ms and peak
                memory, FA's queued device ms a call and a traced stage;
     attention — FA, the masked-attention kernel of the flash form, against
                its plain version on the operands the main path gives it
                (layer 0 of the flash cross-encoder's first packed and flat
                calls on one batch: [128, 256, 12, 64] with segments and
                [512, 256, 12, 64], bf16), a query-encoder shape and a
                ragged case with all-pad rows in bf16 and f32: within
                ATTN_TOL, repeated launches bit-identical; at the packed
                shape kernel / plain CUDA-event times in turns, the library
                call's (scaled_dot_product_attention, memory-efficient
                backend, same float bias) and the bound from the allowed
                pairs;
     rerank_forms — the same searcher and batch with the other forms of the
                stage: packed and flat with einsum_bf16 and flash attention
                (with_attention; flash runs FA in every layer, its launches
                counted in the stage and in the search), the flat cascade at
                (keep 25, stage1 auto = the corpus p90 length), the
                length-bucketed stage on aligned_buckets' ladder and the
                packed stage of the int8 view (quantized; its packed rows
                on FA, as the default stage's): logits within
                0.04 of the f32 forward (the cascade's kept slots), stage ms
                (median of 3) and peak memory; all but the flat attention
                forms also search the first 64 queries (FA's count set to 0 just
                before and read just after; fused output checked, the head
                the same set as the default stage's, top-10 overlap with
                it); then each form held to itself, card against CPU, layer
                by layer from the same inputs, on 4 packed rows in f32
                (einsum_bf16 and int8 within half their gap to einsum in
                every layer, flash within 1e-4), and the int8
                codes of the card bit-equal to the CPU's;
     t5       — a T5CrossEncoder at the CLI's --backbone t5 widths (d_model
                512, 6 layers, 8 heads, d_ff 2,048, 32 buckets, max
                distance 128; bf16, random seeded weights) as the slice's
                cross-encoder, packed and flat over the same heads: logits
                within 0.01 of its f32 forward, stage ms, peak memory, a
                192-query search;
     query_encoders — the slice's query encoders swapped for their
                einsum_bf16, flash and int8 views (set_encoder_attention,
                quantize_encoders): per leg top-100 overlap with the default
                form (>= 0.95; int8 >= 0.9), the legs' ms on one batch, peak
                memory, FA's launches in the flash form's search;
     checkpoint — the four full-width models (DPR, SPLADE, ColBERT, the
                cross-encoder) saved in the JAX package's checkpoint format
                and loaded back in bf16: query encodings (192 queries) and
                logits bit-equal to the originals'; seconds and bytes each;
     persist  — the slice's searcher over its first PERSIST_DOCS (1,024)
                docs, built with the same models and options, with the
                cross-encoder's doc tokens, saved with
                save_indexes to a temporary directory and reloaded into a
                fresh HybridSearcher: every reloaded array equals the
                in-memory one after the format's own f16 rounding (the bf16
                corpus matrices and token index are stored as f16); the
                reloaded searcher's per-leg and fused (reranked) lists over
                the 192 queries are bit-equal to those of the in-memory
                searcher with that rounding applied, and against the
                in-memory searcher itself bit-equal for a leg whose arrays
                all round-trip exactly, else a top-100 overlap >= 0.99; the
                reloaded searcher launches each kernel as often as the
                in-memory one (K1); save and load seconds and bytes on disk
                per component;
     server   — a SearchServer (127.0.0.1, port 0, max_batch 64) over the
                reloaded slice without the rerank stage: 192 single-query
                POSTs from 32 client threads (in a process of their own), 3
                POSTs of 64 queries, one
                malformed body (HTTP 400); every answer equals the direct
                search's top-10 ids with scores within 1e-5; fewer batches
                than requests; requests/s, p50 / p99 request ms, batches and
                mean batch ms;
     cli      — fusion_tpu_torch.cli.main in process on a fixture JSON of the
                slice's first 1,024 docs and 192 dev questions (the zipf words
                spelled in consonants, which the CLI's BM25 preprocessing
                keeps as they are), the [checkpoint] models as --*_path:
                serve --task build and serve --task search with all four
                retrievers and the rerank (K1 once per batch; the ranking
                TSV has 192 rows of in-range unique ids, top-100 overlap
                >= 0.99 with the in-memory searcher that the build made),
                hybrid with percentile-rank NSF over BM25, DPR and ColBERT
                (K1 launches) and hybrid with BM25 and the rerank; each
                performance_hybrid.json holds every metric of
                run_evaluation;
     segmented — streaming updates over the slice: a SegmentedHybridSearcher
                with [index]'s build kwargs (cross-encoder included) over
                the slice's first SEG_DOCS (9,970) docs: the first 5,970,
                then the last 4,000 added with their BM25 docs (a second
                neural segment, BM25 rebuilt over all 9,970 by the C++
                builder, which must compile); against a searcher built with
                [index]'s kwargs over those docs: each system's merged top-100
                overlap >= 0.99, BM25 scores at shared ids within rtol 1e-5
                (idf is global), the fused top 1,000 checked, the flat-
                reranked head a permutation of the fused head; 64 top-1 hits
                deleted (none comes back, rows non-increasing), then
                compact (one segment, n_docs 9,906, top-100 overlap >= 0.99
                with the tombstoned lists); build, add (BM25 rebuild and
                encoding), delete and compact seconds; ms per 64-query batch
                with one segment, two, after compact (K1 once per segment a
                batch, counted) and with the flat rerank; peak memory;
     segmented_server — that searcher (rerank stage off) behind a
                SearchServer: 192 single-query requests from 32 client
                threads (a process of their own) paced over ~9 s, while
                1,000 new docs are added and 32 served top-1 hits deleted:
                /healthz reports n_docs after each update, no request
                fails, no deleted id is served after its delete returned;
                requests/s, p50 / p99, update seconds;
     native   — the C++ posting builders (csrc/bm25_builder.cpp,
                impact_packer.cpp, built by g++) against the numpy builders,
                byte for byte: BM25 postings over the slice's corpus, the
                chunked (docs_per_chunk 32,768, cap 64) and flat (cap 4,096)
                impact packers over a seeded COO of 2^18 docs x 32 postings;
                both times each;
     cli_datasets — the CLI in process on an mMARCO-schema fixture of the
                first CLI_DOCS (1,024) docs: bm25 --task evaluate --dataset
                mmarco-fr, colbert --task train / test --dataset mmarco-fr (the test
                through K1, counted) and dpr --task train / test --dataset
                mrtydi-ja at --tiny; then [mmarco_reader] times
                MmarcoReader.sample_from_hard_negatives over 50,000 seeded
                synthetic records;
     lleqa_parity — fusion_tpu_torch/tools/run_lleqa_parity.py: (a) the JAX
                package's 24-article harness fixture with tiny checkpoints
                the port saves, on the card and on the CPU: each leg's
                lists equal but inside runs of CPU scores within 2^-8 of
                the row's largest (2^-7 for ColBERT, whose token index is
                bf16 on the card), such legs counted; the card's fused
                lists held so (ties within 1e-5) to the CPU's fusion of the
                card's legs, its reranked lists to the CPU's rerank of the
                card's fused lists; metrics within 1e-6 but where such a
                tie lies; (b) CamemBERT-base
                width in bf16 (seeded, saved and loaded by the port) on a
                synthetic LLeQA of 1,024 French-like articles (512 tokens
                read; one word in eight a rarer term the questions name)
                and 64 dev questions, NSF over percentile ranks, the
                rerank of the top 100 at 512 tokens: seconds per system, K1
                counted (> 0), the gate passing targets taken from the run
                and exiting 1 on far ones;
     recall_study — tools/recall_study.py in process at 65,536 docs and
                16,384 ColBERT docs (the tool's widths), every count set to
                0 just before and read just after: K1, K2, K3 and K4 launch;
                every overlap in [0, 1], the int8 exact merge >= 0.9;
     roofline — tools/probe_hybrid_roofline.py's sweep (B 32, 64, 128, 256;
                plain and stacked) over the slice's corpus and encoders:
                one line per row (ms a batch, queries/s, MFU), K1 counted,
                the stacked fused ids equal to the plain ones or overlapping
                them >= 0.99 at 100;
     studies  — tools/cascade_study.py (with --int8) at 300 training steps,
                int8_encoder_study.py at 200 and preprocessor_study.py over
                10,000 docs and 250 queries, the other shapes the tools'
                defaults: their headline numbers;
 11. scale_build — HybridSearcher.build(scale_mode=True, int8_corpus=True,
                dense_impl="fused", splade_impl="scatter") over the same
                corpus and models, all four legs (impact_cap 1024: at 14
                chunks of 2048 docs, 64 query terms x the equal-mass
                per-chunk cap must fit the 8,192-posting layout); search 192
                queries at batch 64: K1, K2 and K3 each launch; fused output
                checked; warm timing and peak memory; then [persist] of it
                (its int8 corpora, impact indexes and rescore store
                round-trip exactly; K1, K2 and K3 launch as in memory);
 12. plaid_build — the same build with colbert_compressed=True and
                colbert_plaid=True (serving defaults: nbits 2, IVF cap 1,024,
                nprobe 4, ncand 1,024, no prune tier, gather rescore); search
                192 queries at batch 64: K2, K3 and K4 each launch; fused
                output checked; on one batch the exhaustive compressed search
                (decompress + K1) and ColBERT.search's compressed branch
                against the same search with the plain maxima (top-100
                overlap >= 0.99 each) and PLAID against it (overlap
                reported, not a gate); build time by part (encode, k-means,
                compression, IVF), warm timing and peak memory; then
                [persist] of it (codes and IVF exact, centroids stored as
                f16: PLAID's centroid probe is a discrete choice that the
                rounding moves, so its leg's and the fused lists' overlap
                with the unrounded searcher is reported, not gated; K2, K3
                and K4 launch as in memory);
     sharded  — the multi-device serving tier over that searcher with the
                slice's cross-encoder in the flash form (packed rerank of the
                fused top 100: FA): first one rank in this process on an NCCL
                group (ShardedHybridSearcher on make_mesh(index=1)): each
                leg's top-100 overlap with the single-device searcher 1.0 and
                the fused top 1,000 the same ids; ms per batch of both in
                turns, the time inside the collectives (none run on one
                rank), launches per batch.  Then two ranks on the one card
                over gloo (NCCL refuses two ranks on one device), each a
                child process of this script that loads the searcher this
                process saved (torch.save), keeps its half and serves the 192
                queries: each leg's merged list through the kernels against
                the same with K2, K3, K4 and FA pointed at their plain
                versions on the same card tensors (top-100 overlap >= 0.99),
                BM25's merged list equal to the single-device one (ids and
                scores bit-equal), the fused list checked, the reranked head
                a permutation of the fused head, the packed stage's logits
                with FA against its plain version (within 0.04), PLAID's
                overlap with the single-device leg (reported); the six
                sharded functions of the index forms at S = 2 against their
                single-device searches (impact bit-equal; dense, the
                token-major MaxSim (K1) and the compressed one (K1) equal up
                to ties within 1e-5; scatter (K3) within K3's bound; PLAID
                (K4) overlap reported); ms per batch, collective ms and
                bytes per batch, peak memory per rank (the two ranks share
                one card's SMs: no speed-up figure); a rank's failure or a
                timeout fails the phase;
     sharded_server — the same two ranks serve that sharded searcher over
                HTTP: SearchServer on both, rank 0 listening on 127.0.0.1
                and sending each coalesced batch to both; 224 single-query
                requests (the 192 queries, the first 32 again; topk 3 / 5 /
                10 by turns) from 32 client threads in a process of their
                own: every answer its batch's own lists on the searcher (ids
                exact, scores within 1e-5), mean top-k overlap >= 0.75 with
                the lists in the slice's batches, the ranks running the same
                batches; a batch that raises on both ranks gets a 500 and
                the next request is served; /healthz counts all 27,940 docs;
                requests/s, p50 / p99, batches, collective ms / MB / calls a
                batch and K1-K4 / FA launches per rank (counts zeroed before
                the server starts, read after it stops);
 13. scale_mmarco — the three-leg scale-mode searcher (BM25 impact index, int8
                DPR, SPLADE scatter + exact rescore) at mMARCO's 8,912,896 docs:
                the query side is real (tokenizers, the zipf BM25Index, the
                CamemBERT-width DPR and SPLADE encoders), the index arrays are
                synthesized on the card from seeded generators at
                BENCH_MMARCO_r05.json's serving-default shapes (BM25 cap 2048
                over the BM25Index's own vocabulary; int8 DPR H 768; SPLADE
                chunks of 16,384 docs, capc 32, rescore store K 128 at depth
                512, over the encoder's 32,005 terms); search 192 queries at
                batch 64: K2 and K3 launch; fused output checked; the DPR and
                SPLADE legs through the kernels against the same legs through
                the plain versions on one batch (top-100 overlap >= 0.99);
                warm timing and peak memory.  Then ColBERT joins as the fourth
                leg: a PLAID index synthesized on the card at
                bench_mmarco.py's shapes (C 131,072 centroids ~ N(0, 0.08^2),
                Ld 32, nbits 2 codes of random bytes, bucket weights
                [-0.04, -0.01, 0.01, 0.04], an all-ones u8 mask, a deduped IVF
                of cap 1,024), the real CamemBERT-width ColBERT query encoder;
                K4 against its plain version at the serving shape (Q 64 x
                K 512 over those arrays, byte-equal; device time per call
                from 10 back-to-back calls queued behind a device sleep, and
                median CUDA-event stream times of 10 alternating runs, host
                calls included; the calls cycle through 10 random index
                sets); search 192 queries: K2, K3 and K4 launch; the
                PLAID leg through K4 against the same leg with the plain
                gather (top-100 overlap >= 0.99, max score difference
                reported); the served ColBERT leg traced on one batch: device
                time inside each plaid.* span of index/plaid.py,
                device operations and stream time per call; warm timing and
                peak memory of the four-leg searcher.

``--profile`` adds a torch.profiler pass over one warm search of each
searcher and prints the device busy share and the top kernels.

Before them, each maxsim_variants run and each probe tool prints its own
JSON record.  The line before the last is the kernels' JSON record
(launches from the slice's search for K1, with the segmented searcher's
two-segment search beside them, the four-leg mMARCO search for
K2, K3 and K4, the two bench runs for K1-v1 and K1-v2, the probe tools'
runs for P3, P4 and P5, the packed flash search of [rerank_forms] for FA
and [train_flash]'s flash run for FA-bwd, and for K1-K4 and FA the
launches on [sharded]'s two-rank path and [sharded_server]'s beside them,
for K1-K4 those of [lleqa_parity] (K1), [recall_study] and [roofline] (K1),
of [examples] (K1: quickstart; K4: scale_serving) and of [tpu_tests] (K2,
K4, FA),
for FA and FA-bwd [train_parallel]'s, in all and by run; ms are CUDA-event medians for
K1-K3, K1-v1, K1-v2, P3-P5, FA and FA-bwd and queued device times for K4;
bound_ms is the least time an H100 SXM could take for the same work, from
this run's shapes and data; library_ms is index_select's time for K4,
scaled_dot_product_attention's for FA and its backward's for FA-bwd, and
null elsewhere: no one PyTorch call computes the others' functions); the last line is
{"ok": true, "device": {...}}.  Matmul precision on the card: TF32 off for
matmuls and cuDNN, bf16 reduced-precision reductions off.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import itertools
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
import warnings

REPO = os.path.dirname(os.path.abspath(__file__))
KERNEL_TOL = (1e-2, 1e-3)  # K1, K1-v1, K1-v2: atol, rtol
K2_TOL = (1e-5, 4e-6)
K3_TOL = (1e-6, 1e-5)
# the tiny f32 rerank searcher, CPU vs card and packed vs flat: fused scores
# at most 9.5e-7 apart on an H100
RERANK_SMALL_TOL = 1e-5
RERANK_SMALL_DEPTH = 10
# [attention]: the masked-attention kernel against its plain version
# (atol, rtol): bf16 rounds the unnormalized probabilities before · v where
# the plain version rounds the normalized ones, ~1 bf16 ulp of an output
# (0.0078-0.0156 on an H100); f32 sums in another order (4.8e-7)
ATTN_TOL = {"bf16": (3e-2, 1e-2), "f32": (1e-5, 1e-5)}
# [rerank_forms] same form, card vs CPU: packed rows of the first chunk,
# and the f32 flash trunk's limit (the kernel's f32 body against its plain
# version through 12 layers)
SAME_FORM_ROWS, SAME_FORM_F32_TOL = 4, 1e-4
# the full-width bf16 rerank logits against an f32 forward of the same
# weights: 0.012 (packed) and 0.013 (flat) apart on an H100, with the
# logits spread over ±0.24; [rerank_forms] 0.012-0.014 for the other
# attention forms, the cascade and the buckets, 0.019 for int8
RERANK_LOGIT_TOL = 0.04
# [rerank_packed_fa]: the benchmark's packed rows (queries cut at 32
# tokens, docs at 220: rows 384 wide, 85 a chunk) and its cross-encoder's
# weight spread, and perfbench's limits of the rerank's readings
PACKED_FA_LQ, PACKED_FA_LD, PACKED_FA_STD = 32, 220, 0.05
PERFBENCH_RERANK_CONFIG = "perfbench/configs/lleqa-camembert-base.json"
# [t5]: the bf16 T5 cross-encoder's logits against its f32 forward (0.0021
# on an H100, the logits spread over ±0.43)
T5_LOGIT_TOL = 0.01
# [query_encoders]: top-100 overlap of each leg with the default form's,
# set from a dev run of the phase on an H100 (0.979-0.991 for einsum_bf16
# and flash, 0.949-0.973 for int8)
ENCODER_FORM_OVERLAP, ENCODER_INT8_OVERLAP = 0.95, 0.9
# [cli]: the fixture's docs, the first CLI_DOCS of the slice's corpus (cut
# to keep the whole run well inside its time limit; 2,048 before the cut
# that made room for [examples], [tpu_tests] and [chunked_impact])
CLI_DOCS = 1_024
# [persist] slice: the docs of the searcher it saves and reloads (cut from
# the whole slice to keep the run inside its time limit: the f16 token
# index's savez_compressed took ~85 s over 27,940 docs; 4,096 docs before
# the cut that made room for this slice's phases)
PERSIST_DOCS = 1_024
N_DOCS, BATCH, N_QUERIES, TOPK, LQ, LD, DIM = 27_940, 64, 192, 1000, 32, 128, 128
RUNS = 10  # alternating kernel / plain timing runs
REPEATS = 10  # repeated launches that must give bit-identical outputs
MM_DOCS, MM_H, MM_DPC, MM_CAPC, MM_BM25_CAP, MM_STORE_K, MM_DEPTH = (
    8_912_896, 768, 16_384, 32, 2048, 128, 512,
)
SPLADE_VOCAB = 32_005  # CamemBERT's vocabulary: the SPLADE encoder's output width
# the PLAID index of bench_mmarco.py: centroids, tokens per doc, bits per
# dimension, docs per centroid list, and the serving rescore chunk
MM_C, MM_LD, MM_NBITS, MM_IVF_CAP, MM_CAND_CHUNK = 131_072, 32, 2, 1024, 512


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def phase(name: str, t0: float, **fields) -> None:
    extra = " ".join(f"{k}={v}" for k, v in fields.items())
    print(f"[{name}] {time.perf_counter() - t0:.3f}s {extra}", flush=True)


def timed_ms(torch, fn, runs: int) -> list[float]:
    """Per-run CUDA-event times (ms) of ``fn()``."""
    out = []
    for _ in range(runs):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        out.append(start.elapsed_time(end))
    return out


def device_events(prof) -> list:
    """The device operations of a torch.profiler trace (kernels, copies,
    fills), without the device-side spans of ``record_function`` ranges
    (the program's spans are ``fusion.*``)."""
    from fusion_tpu_torch.utils.profiling import PREFIX

    return [
        e for e in prof.events()
        if e.device_type.name == "CUDA" and not getattr(e, "is_user_annotation", False)
        and not e.name.startswith(PREFIX + ".")
    ]


ATTENTION_KERNELS = ("fa_forward_kernel", "fa_dkv_kernel", "fa_dq_kernel", "rowdot_kernel")


def attention_device_ms(torch, fn, runs: int = 5) -> dict:
    """A torch.profiler trace of ``runs`` warm calls of ``fn``: device ms per
    call in all and by the bf16 attention kernels' names (a kernel launched
    through ctypes links to no CPU op, so it is read by name), with the
    launches the trace holds per call (it may hold only some of them, as it
    held only some back-to-back K4 calls: ``queued_ms`` gives the device
    time)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
    ops = device_events(prof)
    out = {"device_ms": sum(e.self_device_time_total for e in ops) / 1000 / runs}
    for key in ATTENTION_KERNELS:
        hits = [e.self_device_time_total for e in ops if key in e.name]
        if hits:
            out[f"{key}_ms"] = sum(hits) / 1000 / runs
            out[f"{key}_traced_launches"] = len(hits) / runs
    return out


def queued_ms(torch, fn, runs: int, sleep_cycles=50_000_000) -> tuple[float, bool]:
    """(device time in ms per call of ``fn()``, whether the queue stayed
    full): ``runs`` back-to-back calls between two CUDA events that the host
    enqueues behind a device sleep of ``sleep_cycles`` clocks (~25 ms), so
    every call is queued before the first one starts and no host time falls
    between the events.  The queue stayed full if the host finished
    enqueueing before the sleep ended."""
    sleep0, start, end = (torch.cuda.Event(enable_timing=True) for _ in range(3))
    torch.cuda.synchronize()
    sleep0.record()
    torch.cuda._sleep(sleep_cycles)
    t0 = time.perf_counter()
    start.record()
    for _ in range(runs):
        fn()
    end.record()
    enqueue_ms = (time.perf_counter() - t0) * 1000
    torch.cuda.synchronize()
    return start.elapsed_time(end) / runs, enqueue_ms < sleep0.elapsed_time(start)


def cycling(fn, args, start=0):
    """``fn`` as a no-argument call that takes the next of ``args`` each time."""
    it = itertools.islice(itertools.cycle(args), start, None)
    return lambda: fn(next(it))


def alternating_ms(torch, kernel_fn, plain_fn, runs: int) -> tuple[float, float]:
    """Median CUDA-event times of kernel and plain, taken in turns so drift
    hits both alike."""
    k_ms, p_ms = [], []
    for _ in range(runs):
        k_ms += timed_ms(torch, kernel_fn, 1)
        p_ms += timed_ms(torch, plain_fn, 1)
    return statistics.median(k_ms), statistics.median(p_ms)


def repeat_identical(torch, fn, first, repeats: int = REPEATS) -> bool:
    """Whether ``repeats`` more launches of ``fn`` give outputs bit-identical
    to ``first`` (a pipeline race shows as outputs that change)."""
    return all(torch.equal(first, fn()) for _ in range(repeats))


def kernel_vs_plain(torch, maxsim, ld, n, d, ql, seed, runs, doc_slice=None):
    """K1: (max |kernel - plain|, kernel ms median, plain ms median).  With
    ``doc_slice = (total, start)`` the corpus is the view [:, start:start+n]
    of a [ld, total, d] corpus (token stride total*d, not n*d), as
    ``maxsim_search_tm`` passes its doc blocks.  With ``runs`` the kernel is
    also launched REPEATS more times and must give the same bits."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    total, start = doc_slice or (n, 0)
    corpus = torch.randn(ld, total, d, device="cuda", generator=gen).to(torch.bfloat16)[:, start : start + n]
    q = torch.randn(ql, d, device="cuda", generator=gen).to(torch.bfloat16)
    label = f"K1 {(ld, n, d, ql)}" + (f" on docs [{start}, {start + n}) of {total}" if doc_slice else "")
    got = maxsim.maxsim_maxima_cuda(q, corpus)
    want = maxsim.maxsim_maxima_plain(q, corpus)
    torch.cuda.synchronize()
    check(got.shape == (n, ql) and bool(torch.isfinite(got).all()), f"{label}: kernel output bad")
    err, ok = within(torch, got, want)
    check(ok, f"{label}: kernel disagrees, max err {err}")
    k_ms = p_ms = None
    if runs:
        check(repeat_identical(torch, lambda: maxsim.maxsim_maxima_cuda(q, corpus), got),
              f"{label}: outputs differ between launches")
        k_ms, p_ms = alternating_ms(
            torch, lambda: maxsim.maxsim_maxima_cuda(q, corpus),
            lambda: maxsim.maxsim_maxima_plain(q, corpus), runs,
        )
    return err, k_ms, p_ms


def rates(flops, nbytes, ms, bound_ms) -> dict:
    """Achieved TFLOP/s and TB/s of a kernel time, and its share of the bound."""
    return {"tflops": flops / ms / 1e9, "tbps": nbytes / ms / 1e9, "share_of_bound": bound_ms / ms}


def maxsim_inputs(torch, q, lq, n, ld, d, seed):
    """The MaxSim bench's seeded inputs (``tools/bench_maxsim.make_inputs``:
    40-128 valid tokens per doc, every 997th doc fully masked, masked tokens
    zero), with the last 3 tokens of every 3rd query masked."""
    from fusion_tpu_torch.tools import bench_maxsim

    q_flat, q_mask, corpus_tm, mask_tm = bench_maxsim.make_inputs(q, lq, n, ld, d, seed)
    q_mask[::3, max(lq - 3, 1):] = 0.0
    return q_flat, q_mask, corpus_tm, mask_tm


def within(torch, got, want):
    """max |got - want|, and whether every element is within KERNEL_TOL."""
    atol, rtol = KERNEL_TOL
    err = (got - want).abs()
    return err.max().item(), bool((err <= atol + rtol * want.abs()).all())


def k1v1_check(torch, maxsim, q, lq, n, ld, d, seed, runs, strict=True, dead_ends=False):
    """K1-v1 (strict mask) or, with ``strict=False``, the zeroed fused sum:
    (max |kernel - plain|, kernel ms, plain ms, device ms, bound inputs).
    Under the strict mask fully masked docs must score -1e9 x the valid
    query tokens within the same bound; ``dead_ends`` masks the corpus's
    first and last docs wholly.  With ``runs`` the kernel is also launched
    REPEATS more times and must give the same bits (no atomics)."""
    from fusion_tpu_torch.tools import bench_maxsim

    q_flat, q_mask, corpus_tm, mask_tm = maxsim_inputs(torch, q, lq, n, ld, d, seed)
    if dead_ends:
        mask_tm[:, [0, n - 1]] = 0.0
        corpus_tm[:, [0, n - 1]] = 0
    dm = mask_tm if strict else None
    kernel = lambda: maxsim.maxsim_fused_cuda(q_flat, q_mask, corpus_tm, dm)  # noqa: E731
    plain = lambda: maxsim.maxsim_fused_plain(q_flat, q_mask, corpus_tm, dm)  # noqa: E731
    got, want = kernel(), plain()
    torch.cuda.synchronize()
    label = f"K1-v1 {'strict' if strict else 'zeroed'} Q{q} Lq{lq} N{n} Ld{ld} D{d}"
    check(got.shape == (q, n) and bool(torch.isfinite(got).all()), f"{label}: output bad")
    err, ok = within(torch, got, want)
    check(ok, f"{label}: kernel disagrees with plain, max err {err}")
    if strict:
        dead = mask_tm.amax(dim=0) <= 0
        check(bool(dead.any()) and (not dead_ends or bool(dead[0] and dead[-1])),
              f"{label}: the inputs lack their fully masked docs")
        expect = (-1e9 * q_mask.sum(dim=1, keepdim=True)).expand(-1, int(dead.sum()))
        dead_err, ok = within(torch, got[:, dead], expect)
        check(ok, f"{label}: fully masked docs score {got[:, dead].min().item()}, want -1e9 x valid tokens")
        err = max(err, dead_err)
    k_ms = p_ms = dev_ms = None
    if runs:
        check(repeat_identical(torch, kernel, got), f"{label}: outputs differ between launches")
        k_ms, p_ms = alternating_ms(torch, kernel, plain, runs)
        dev_ms = bench_maxsim.device_ms(kernel, runs)
    nbytes = corpus_tm.nbytes + q_flat.nbytes + q_mask.nbytes + 4 * q * n + (mask_tm.nbytes if strict else 0)
    return err, k_ms, p_ms, dev_ms, (2.0 * q * lq * n * ld * d, nbytes)


def k1v2_check(torch, maxsim, ql, n, ld, d, seed, runs, tchunk=1):
    """K1-v2 with ``tchunk`` doc tokens per ring stage: f32 within KERNEL_TOL
    of the plain maxima, bf16 within one bf16 ulp of the plain version's
    rounded max (the f32 maxima differ in their last bits and may round to
    neighbours); with ``runs``, both modes bit-identical over REPEATS more
    launches; (max f32 error, max bf16 error, f32 kernel ms, plain ms, bound
    inputs)."""
    from fusion_tpu_torch.tools.bench_maxsim import bf16_ulp

    q_flat, _, corpus_tm, _ = maxsim_inputs(torch, 1, ql, n, ld, d, seed)
    label = f"K1-v2 QL{ql} N{n} Ld{ld} tchunk {tchunk}"
    errs = []
    for reduce in ("f32", "bf16"):
        got = maxsim.maxsim_maxima_v2_cuda(q_flat, corpus_tm, reduce=reduce, tchunk=tchunk)
        want = maxsim.maxsim_maxima_v2_plain(q_flat, corpus_tm, reduce=reduce)
        torch.cuda.synchronize()
        check(got.shape == (ql, n) and bool(torch.isfinite(got).all()), f"{label} {reduce}: output bad")
        if reduce == "bf16":
            check(torch.equal(got, got.to(torch.bfloat16).float()), f"{label}: bf16 maxima not bf16 values")
            err = (got - want).abs()
            errs.append(err.max().item())
            check(bool((err <= bf16_ulp(want)).all()), f"{label} bf16: more than one ulp off, {errs[-1]}")
        else:
            err, ok = within(torch, got, want)
            errs.append(err)
            check(ok, f"{label} f32: kernel disagrees with plain, max err {err}")
        if runs:
            again = lambda r=reduce: maxsim.maxsim_maxima_v2_cuda(q_flat, corpus_tm, reduce=r, tchunk=tchunk)  # noqa: E731
            check(repeat_identical(torch, again, got), f"{label} {reduce}: outputs differ between launches")
    k_ms = p_ms = None
    if runs:
        k_ms, p_ms = alternating_ms(
            torch, lambda: maxsim.maxsim_maxima_v2_cuda(q_flat, corpus_tm),
            lambda: maxsim.maxsim_maxima_v2_plain(q_flat, corpus_tm), runs,
        )
    nbytes = corpus_tm.nbytes + q_flat.nbytes + 4 * ql * n
    return errs[0], errs[1], k_ms, p_ms, (2.0 * ql * n * ld * d, nbytes)


def unpack_bins(torch, packed):
    """Packed bin maxima → (clean scores, in-bin offsets)."""
    bits = packed.view(torch.int32)
    clean = torch.where(torch.isfinite(packed), (bits & -16).view(torch.float32), -torch.inf)
    return clean, bits & 0xF


def compare_bins(torch, got, want, gap, tol, label):
    """Kernel vs plain packed bins: the -inf pattern equal, clean scores within
    tol, offsets equal where the plain bin's two best scores are more than
    the tolerance apart.  Returns the max |error| of the clean scores."""
    atol, rtol = tol
    g, g_off = unpack_bins(torch, got)
    w, w_off = unpack_bins(torch, want)
    check(got.shape == want.shape, f"{label}: shapes {tuple(got.shape)} vs {tuple(want.shape)}")
    check(not bool(torch.isnan(got).any()), f"{label}: NaN in the kernel's output")
    fin = torch.isfinite(w)
    check(bool((torch.isfinite(g) == fin).all()), f"{label}: the -inf pattern differs")
    err = torch.where(fin, (g - w).abs(), 0.0)
    bound = atol + rtol * w.abs()
    check(bool((err <= torch.where(fin, bound, 1.0)).all()), f"{label}: max err {err.max().item()}")
    clear = fin & (gap > atol + rtol * w.abs())
    bad = int((clear & (g_off != w_off)).sum())
    check(bad == 0, f"{label}: {bad} bin offsets differ where the plain top-2 are apart")
    return err.max().item(), int(clear.sum())


def k2_gap(torch, dense_topk, q, values, scales, n_docs, doc_block=2048, dead_rows=True, rows_per_step=65536):
    """Per bin: plain best score minus second best (f32 [Q, N/16])."""
    from fusion_tpu_torch.ops.mips import matmul_f32

    n_pad = values.shape[0]
    lanes = doc_block // 16
    gap = torch.empty((q.shape[0], n_pad // 16), device=q.device)
    lane = torch.arange(lanes, device=q.device)
    for start in range(0, n_pad, rows_per_step):
        vals = values[start : start + rows_per_step]
        nb = vals.shape[0] // doc_block
        raw = matmul_f32(q, vals.to(torch.bfloat16).T)
        s = scales[start : start + rows_per_step]
        sc = dense_topk._apply_scales(raw, s) if dead_rows else raw * s[None, :]
        doc = start + (torch.arange(nb, device=q.device)[:, None, None] * doc_block
                       + torch.arange(16, device=q.device)[None, :, None] * lanes + lane)
        sc = torch.where(doc < n_docs, sc.view(-1, nb, 16, lanes), -torch.inf)
        top2 = torch.topk(sc, 2, dim=2).values  # [Q, nb, 2, lanes]
        gap[:, start // 16 : start // 16 + nb * lanes] = (top2[:, :, 0] - top2[:, :, 1]).reshape(q.shape[0], -1)
    return gap


def k2_inputs(torch, q_n, n_real, n_pad, h, seed, dead_every=97, device="cuda"):
    """Seeded int8 rows, f32 scales (every ``dead_every``-th row and the pad
    rows past ``n_real`` at scale 0) and l2-normalized bf16 queries."""
    gen = torch.Generator(device=device).manual_seed(seed)
    values = torch.randint(-127, 128, (n_pad, h), device=device, generator=gen, dtype=torch.int8)
    scales = torch.rand(n_pad, device=device, generator=gen) * 2e-3 + 5e-4
    scales[::dead_every] = 0.0
    scales[n_real:] = 0.0  # the build pads: scale 0, masked by n_docs
    q = torch.randn(q_n, h, device=device, generator=gen)
    return (q / q.norm(dim=1, keepdim=True)).to(torch.bfloat16), values, scales


def k2_check(torch, dense_topk, q_n, n_real, n_pad, h, seed, runs, dead_every=97, device="cuda",
             doc_block=2048, dead_rows=True, inputs=None):
    """K2 (or, with ``dead_rows=False``, the no-mask variant P3) at one
    shape and doc block: (max error, checked bins, kernel ms, plain ms); with
    ``runs`` the kernel is also launched REPEATS more times and must give the
    same bits.  ``inputs`` reuses (q, values, scales) from ``k2_inputs``."""
    q, values, scales = inputs or k2_inputs(torch, q_n, n_real, n_pad, h, seed, dead_every, device)
    kernel = lambda: dense_topk.binmax_cuda(q, values, scales, n_real, doc_block, dead_rows)  # noqa: E731
    plain = lambda: dense_topk.binmax_plain(q, values, scales, n_real, doc_block, dead_rows=dead_rows)  # noqa: E731
    got, want = kernel(), plain()
    torch.cuda.synchronize()
    gap = k2_gap(torch, dense_topk, q, values, scales, n_real, doc_block, dead_rows)
    label = f"{'K2' if dead_rows else 'P3'} Q{q.shape[0]} N{n_real} doc_block {doc_block}"
    err, checked = compare_bins(torch, got, want, gap, K2_TOL, label)
    del gap
    k_ms = p_ms = None
    if runs:
        check(repeat_identical(torch, kernel, got), f"{label}: outputs differ between launches")
        k_ms, p_ms = alternating_ms(torch, kernel, plain, runs)
    return err, checked, k_ms, p_ms


def chunk_gap(torch, scatter_score, docs, vals, dpc, cb=16):
    """Per bin of chunk-major operands [Q, Cp, W]: plain best score minus
    second best (f32 [Q, Cp, dpc/16])."""
    h = scatter_score._plan(dpc)
    q = docs.shape[0]
    gap = torch.empty((q, docs.shape[1], dpc // 16), device=docs.device)
    for ci in range(0, docs.shape[1], cb):
        sc = scatter_score._chunk_scores(docs[:, ci : ci + cb], vals[:, ci : ci + cb], h)
        top2 = torch.topk(sc.reshape(q, -1, 16, dpc // 16), 2, dim=2).values
        gap[:, ci : ci + cb] = top2[:, :, 0] - top2[:, :, 1]
    return gap


def k3_gap(torch, scatter_score, q_terms, q_weights, post_doc, post_impact, dpc, cb=16):
    """Per bin: plain best score minus second best (f32 [Q, C·dpc/16])."""
    c = post_doc.shape[1]
    docs, vals = scatter_score._gather_postings(q_terms, q_weights, post_doc, post_impact, cb)
    return chunk_gap(torch, scatter_score, docs, vals, dpc, cb)[:, :c].reshape(q_terms.shape[0], -1)


def k3_inputs(torch, seed, q_n, kq, vocab, n_chunks, capc, dpc, pad_rows=False, device="cuda"):
    """Seeded chunked-index rows and a query batch (queries have distinct
    terms; every 5th query ends in pad terms of weight 0)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    post_doc = torch.randint(0, dpc, (vocab + 1, n_chunks, capc), device=device,
                             generator=gen, dtype=torch.int32).to(torch.int16)
    post_impact = (torch.rand(vocab + 1, n_chunks, capc, device=device, generator=gen)
                   * 2.95 + 0.05).to(torch.float16)
    if pad_rows:  # short posting lists, and a last chunk with none
        fill = torch.rand(vocab + 1, n_chunks, capc, device=device, generator=gen) < 0.6
        fill[:, -1] = False
        post_doc = torch.where(fill, post_doc, torch.full_like(post_doc, -1))
        post_impact = torch.where(fill, post_impact, torch.zeros_like(post_impact))
    post_doc[vocab], post_impact[vocab] = -1, 0.0  # the sentinel row of pad terms
    q_terms = torch.argsort(torch.rand(q_n, vocab, device=device, generator=gen), dim=1)[:, :kq]
    q_terms = q_terms.to(torch.int32).contiguous()
    q_weights = torch.rand(q_n, kq, device=device, generator=gen) * 0.95 + 0.05
    q_terms[::5, kq - kq // 4 :] = vocab
    q_weights[::5, kq - kq // 4 :] = 0.0
    return q_terms, q_weights, post_doc.contiguous(), post_impact.contiguous()


def k3_check(torch, scatter_score, seed, q_n, kq, vocab, n_chunks, capc, dpc, runs,
             pad_rows=False, device="cuda"):
    """K3 at one shape: (max error, checked bins, kernel ms, plain ms, device
    ms).  With ``runs`` the kernel is also launched REPEATS more times, each
    output within K3_TOL of the first (the atomics' order varies; a staging
    race shows as a repeat far off)."""
    from fusion_tpu_torch.tools import bench_maxsim

    args = k3_inputs(torch, seed, q_n, kq, vocab, n_chunks, capc, dpc, pad_rows, device)
    kernel = lambda: scatter_score.scatter_binmax_cuda(*args, dpc)  # noqa: E731
    plain = lambda: scatter_score.scatter_binmax_plain(*args, dpc)  # noqa: E731
    got, want = kernel(), plain()
    torch.cuda.synchronize()
    gap = k3_gap(torch, scatter_score, *args, dpc)
    label = f"K3 Q{q_n} Kq{kq} C{n_chunks} capc{capc} dpc{dpc}"
    err, checked = compare_bins(torch, got, want, gap, K3_TOL, label)
    k_ms = p_ms = dev_ms = None
    if runs:
        for i in range(REPEATS):
            compare_bins(torch, kernel(), got, gap, K3_TOL, f"{label} repeat {i + 1} vs the first launch")
        k_ms, p_ms = alternating_ms(torch, kernel, plain, runs)
        dev_ms = bench_maxsim.device_ms(kernel, runs)
    del gap
    return err, checked, k_ms, p_ms, dev_ms


def pregathered_check(torch, scatter_score, seed, q_n, kq, vocab, n_chunks, capc, dpc, runs,
                      pad_rows=False, device="cuda") -> dict:
    """P5 (chunk-major) and P4 (term-major): the pre-gathered kernel in each
    layout against its plain version, and against K3 on the same index;
    {layout: (max error, checked bins, kernel ms, plain ms, bound inputs,
    device ms)}.  With ``runs`` each layout's kernel is also launched
    REPEATS more times, each output within K3_TOL of the first (a staging
    race shows as a repeat far off), and timed."""
    from fusion_tpu_torch.tools import bench_maxsim

    args = k3_inputs(torch, seed, q_n, kq, vocab, n_chunks, capc, dpc, pad_rows, device)
    k3 = scatter_score.scatter_binmax_cuda(*args, dpc)
    cm = scatter_score._gather_postings(*args, 16)
    tm = scatter_score.gather_postings_term_major(*args, 16)
    gap = chunk_gap(torch, scatter_score, *cm, dpc).reshape(q_n, -1)
    out = {}
    for layout, (docs, vals) in (("chunk_major", cm), ("term_major", tm)):
        label = f"{'P5' if layout == 'chunk_major' else 'P4'} {layout} Q{q_n} C{n_chunks} dpc{dpc}"
        kernel = lambda d=docs, v=vals, lay=layout: scatter_score.scatter_pregathered_cuda(d, v, dpc, lay)  # noqa: E731
        plain = lambda d=docs, v=vals, lay=layout: scatter_score.scatter_pregathered_plain(d, v, dpc, lay)  # noqa: E731
        got, want = kernel(), plain()
        torch.cuda.synchronize()
        err, checked = compare_bins(torch, got, want, gap, K3_TOL, label)
        # against K3 over the same index: the real chunks of the padded output
        k3_err, _ = compare_bins(torch, got[:, : k3.shape[1]], k3, gap[:, : k3.shape[1]], K3_TOL, f"{label} vs K3")
        k_ms = p_ms = dev_ms = None
        if runs:
            for i in range(REPEATS):
                compare_bins(torch, kernel(), got, gap, K3_TOL, f"{label} repeat {i + 1} vs the first launch")
            k_ms, p_ms = alternating_ms(torch, kernel, plain, runs)
            dev_ms = bench_maxsim.device_ms(kernel, runs)
        # operands read once (4-byte docs, 2-byte values), packed bins written
        # once; one f32 add per posting
        out[layout] = (max(err, k3_err), checked, k_ms, p_ms,
                       (float(docs.numel()), docs.nbytes + vals.nbytes + got.nbytes), dev_ms)
    return out


def rerank_small_agreement(torch, np) -> dict:
    """A tiny BM25 + monoBERT searcher (packed and flat stages) on the CPU
    and on the card from the same seeds (f32 models), compared pairwise
    (CPU vs card per stage, packed vs flat on the card): sorted fused scores
    within RERANK_SMALL_TOL, and the same id at every rank whose score no
    other score of its row comes within 2 * RERANK_SMALL_TOL of (exact BM25
    ties may order either way).  {pair: (max score diff, ranks whose ids
    were compared)}."""
    from fusion_tpu_torch.models.crossencoder import CrossEncoder
    from fusion_tpu_torch.models.encoder import EncoderConfig
    from fusion_tpu_torch.serving import HybridSearcher

    docs, queries = zipf_corpus(np, 300, 9, seed=7, vocab=400)
    cfg = EncoderConfig.tiny(vocab_size=512)
    # matrices ten times the seeded init (std 0.2): at std 0.02 the tiny
    # model's logits differ by ~1e-6 across pairs, too little to order them
    seeded = CrossEncoder(cfg, max_length=64, seed=5, device="cpu").module.state_dict()
    params = {name: w * 10 if w.ndim == 2 else w for name, w in seeded.items()}
    out = {}
    for device in ("cpu", "cuda"):
        ce = CrossEncoder(cfg, params=params, max_length=64, device=device)
        for packed in (True, False):
            searcher = HybridSearcher.build(
                dict(enumerate(docs)), bm25_docs=docs, cross_encoder=ce, rerank_depth=RERANK_SMALL_DEPTH,
                rerank_packed=packed, topk=20, device=device,
            )
            check(searcher.active_systems == ["bm25", "monobert"], f"rerank_small: {searcher.active_systems}")
            out[device, packed] = searcher.search(queries, batch_size=4)[0]
    result = {}
    for a_key, b_key in ((("cpu", True), ("cuda", True)), (("cpu", False), ("cuda", False)),
                         (("cuda", True), ("cuda", False))):
        label = f"{a_key} vs {b_key}"
        a_ids, a_scores = out[a_key].ids.numpy(), out[a_key].scores.numpy()
        b_ids, b_scores = out[b_key].ids.numpy(), out[b_key].scores.numpy()
        a, b = -np.sort(-a_scores, axis=1), -np.sort(-b_scores, axis=1)
        fin = np.isfinite(a)
        check(bool((fin == np.isfinite(b)).all()), f"rerank_small: {label} -inf pattern differs")
        err = float(np.where(fin, np.abs(a - b), 0.0).max())
        check(err <= RERANK_SMALL_TOL, f"rerank_small: {label} scores differ by {err}")
        # ranks whose score stands apart from the rest of its row
        with np.errstate(invalid="ignore"):
            gaps = np.abs(a_scores[:, :, None] - a_scores[:, None, :])
        rank = np.arange(a.shape[1])
        gaps[:, rank, rank] = np.inf
        gaps[np.isnan(gaps)] = np.inf
        alone = np.isfinite(a_scores) & (gaps.min(axis=2) > 2 * RERANK_SMALL_TOL)
        head_alone = int(alone[:, :RERANK_SMALL_DEPTH].sum())
        check(head_alone * 2 >= alone[:, :RERANK_SMALL_DEPTH].size,
              f"rerank_small: {label} only {head_alone} reranked ranks stand apart")
        bad = np.argwhere(alone & (a_ids != b_ids))
        check(len(bad) == 0, f"rerank_small: {label} ids differ at (query, rank) {bad[:5].tolist()}")
        result[f"{a_key[0]}_{'packed' if a_key[1] else 'flat'}_vs_{b_key[0]}_{'packed' if b_key[1] else 'flat'}"] = (
            err, int(alone.sum()))
    return result


def stage_profile(torch, fn, top: int = 6) -> dict:
    """One traced call of ``fn``: its device time, the share of its stream
    time the device was busy, and the device operations that took most of
    it (name, ms, calls)."""
    from fusion_tpu_torch.tools.bench_colbert_train import traced_step

    return traced_step(fn, top)


def rerank_check(torch, np, searcher, queries, smi, kernels) -> dict:
    """The main path: the slice searcher with the monoBERT stage, packed
    (the default), and the same with the flat stage
    (``rerank_packed=False``).  Every kernel launch count is set to 0 just
    before the packed search and read just after (``launches``; K1 must have
    run once per batch, FA once a layer and chunk scored, which the search,
    run under ``utils/profiling.tracing()``, also counts as
    ``attention.packed_kernel`` and never as ``attention.packed_einsum``).
    Both searches' fused output checked, the top-100
    head the same set per query in both, the stage's logits on one batch
    compared (max |packed - flat|) and each held to an f32 forward of the
    same weights within RERANK_LOGIT_TOL (the f32 forward is the packed
    stage, so a fault in either stage shows in one of the two), each
    stage's time on that batch (median of 3 CUDA-event runs, host plan and
    read-back included), the packed row fill, analytic FLOPs and the rate
    reached, warm timing and peak memory of each searcher.  One call of
    each stage is traced (``stage_profile``)."""
    from fusion_tpu_torch.models.crossencoder import CrossEncoder
    from fusion_tpu_torch.ops.attention import masked_attention_cuda
    from fusion_tpu_torch.utils import profiling

    flat = dataclasses.replace(searcher, rerank_packed=False)
    ce = searcher.cross_encoder
    check(searcher.rerank_packed and "monobert" in searcher.active_systems, "rerank: the packed stage is not on")
    out = {"depth": searcher.rerank_depth}
    heads = {}
    for name, s in (("packed", searcher), ("flat", flat)):
        if name == "packed":
            reset_counts(*kernels)
            masked_attention_cuda.launches, chunks = 0, []
            plan = ce.plan_packed

            def plan_spy(*a, **kw):  # the chunks each batch's packed stage scores
                got = plan(*a, **kw)
                chunks.append(-(-(int(got[0][2].max()) + 1) // got[4]))
                return got

            ce.plan_packed = plan_spy
            profiling.reset()
            try:
                with profiling.tracing():
                    ranked, _ = s.search(queries, batch_size=BATCH)
            finally:
                del ce.plan_packed
            traced = profiling.snapshot()["counters"]
            profiling.reset()
            out["launches"] = counts(*kernels)
            check(out["launches"]["K1"] >= N_QUERIES // BATCH,
                  f"rerank: MaxSim kernel launched {out['launches']['K1']} times in the main path")
            # FA serves every packed row's attention: once a layer and chunk
            out["launches"]["FA"] = masked_attention_cuda.launches
            out["packed_chunks_scored"] = sum(chunks)
            out["packed_attention_counters"] = {k: v for k, v in traced.items() if k.startswith("attention.")}
            want = ce.cfg.num_layers * sum(chunks)
            check(out["launches"]["FA"] == want > 0
                  and out["packed_attention_counters"] == {"attention.packed_kernel": want},
                  f"rerank: FA launched {out['launches']['FA']} times in the main path's packed search "
                  f"(counters {out['packed_attention_counters']}), not once a layer and chunk ({want})")
        else:
            ranked, _ = s.search(queries, batch_size=BATCH)
        check_ranked(torch, np, ranked, N_QUERIES, TOPK, N_DOCS)
        heads[name] = ranked.ids.numpy()[:, : searcher.rerank_depth]
    out["head_sets_equal"] = all(set(a) == set(b) for a, b in zip(heads["packed"], heads["flat"]))
    out["head_order_equal_frac"] = float((heads["packed"] == heads["flat"]).mean())
    check(out["head_sets_equal"], "rerank: packed and flat heads hold other docs")

    inputs = searcher._prepare_inputs(queries[:BATCH])
    fused = searcher._fuse(searcher._search_batch(inputs))
    head = fused.ids[:, : searcher.rerank_depth]
    valid = head >= 0
    lp = searcher._packed_rerank_stage(inputs, head)
    lf = flat._flat_rerank_stage(inputs, head)
    out["max_logit_gap"] = (lp - lf).abs()[valid].max().item()
    out["max_abs_logit"] = lf.abs()[valid].max().item()
    check(bool(torch.isfinite(lp).all() and torch.isfinite(lf).all()), "rerank: non-finite logits")
    # both bf16 stages against an f32 forward of the same (bf16-valued)
    # weights: the packed stage in f32 equals the flat one to ~1e-6 (CPU
    # tests), so it serves as the reference of either
    ce32 = CrossEncoder(dataclasses.replace(ce.cfg, dtype=torch.float32), params=ce.module.state_dict(),
                        max_length=ce.max_length, device=ce.device)
    ref = dataclasses.replace(searcher, cross_encoder=ce32)._packed_rerank_stage(inputs, head)
    out["max_logit_err_vs_f32"] = {
        "packed": (lp - ref).abs()[valid].max().item(), "flat": (lf - ref).abs()[valid].max().item(),
    }
    check(max(out["max_logit_err_vs_f32"].values()) <= RERANK_LOGIT_TOL,
          f"rerank: bf16 logits off the f32 forward by {out['max_logit_err_vs_f32']} (> {RERANK_LOGIT_TOL})")
    del ce32, ref
    for name, s in (("packed", searcher), ("flat", flat)):
        out[f"{name}_stage_ms"] = statistics.median(timed_ms(torch, lambda s=s: s._rerank(inputs, fused), 3))
        out[f"{name}_stage_profile"] = stage_profile(torch, lambda s=s: s._rerank(inputs, fused))

    # the plan of this batch: fill, rows scored, analytic FLOPs
    head_np = head.cpu().numpy()
    desc, tables, width, nchunks, rpc, _ = ce.plan_packed(
        head_np, searcher.ce_doc_lens, inputs["ce_qlens"], LQ, searcher.ce_doc_tokens.shape[1],
        searcher.ce_doc_tokens.shape[0],
    )
    plen = 2 + desc[4].astype(np.int64) + desc[5]
    n_rows = int(desc[2].max()) + 1
    cfg = ce.cfg
    from fusion_tpu_torch.utils.profiling import attention_flops, trunk_flops_per_token

    ftok = trunk_flops_per_token(cfg)
    useful = float(sum(ftok * p + attention_flops(cfg, p) for p in plen.tolist()))
    packed_flops = n_rows * (ftok * width + attention_flops(cfg, width))  # the rows scored
    ld = searcher.ce_doc_tokens.shape[1]
    flat_len = 2 + LQ + ld + (-(2 + LQ + ld) % 128)
    flat_flops = head_np.size * (ftok * flat_len + attention_flops(cfg, flat_len))
    out.update(
        pairs=int(head_np.size), row_width=width, rows=n_rows, rows_per_chunk=rpc, plan_chunks=nchunks,
        row_fill=float(plen.sum()) / (n_rows * width), flat_pair_len=flat_len,
        useful_tflop=useful / 1e12, packed_tflop=packed_flops / 1e12, flat_tflop=flat_flops / 1e12,
        packed_tflops_per_s=packed_flops / out["packed_stage_ms"] / 1e9,
        flat_tflops_per_s=flat_flops / out["flat_stage_ms"] / 1e9,
    )
    # the flat stage (3x the packed one's time) is timed over the first batch
    # only, to keep the script inside its time limit
    for name, s, qs in (("packed", searcher, queries), ("flat", flat, queries[:BATCH])):
        timing = warm_timing(torch, s, qs, f"rerank_{name}", smi)
        out[f"{name}_ms_per_batch"] = timing["ms_per_batch_median"]
        out[f"{name}_peak_mem_gib"] = timing["peak_mem_gib"]
    return out


def on_einsum_chain(fn):
    """``fn()`` with packed rows' attention kept on the ``einsum`` form's
    chain on the card (``models/encoder.packed_on_kernel`` answering no)."""
    from fusion_tpu_torch.models import encoder

    rule, encoder.packed_on_kernel = encoder.packed_on_kernel, lambda *a: False
    try:
        return fn()
    finally:
        encoder.packed_on_kernel = rule


def rerank_reading_limits() -> dict:
    """perfbench's limits of the rerank's readings (its CamemBERT-base
    configuration's ``check.limits``)."""
    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)), PERFBENCH_RERANK_CONFIG)) as f:
        limits = json.load(f)["check"]["limits"]
    return {k: v for k, v in limits.items() if k.startswith("rerank.")}


def head_readings(np, got, ref) -> dict:
    """perfbench's rerank readings (``perfbench/check.judge``) of the logits
    ``got`` against ``ref`` [Q, K]: the head ranked by ``got`` and scored by
    its sigmoid, as a search's final list over a fused list of the head
    alone (no legs; the fusion reading this leaves is dropped)."""
    from perfbench.check import judge

    qn, k = got.shape
    order = np.argsort(-got, axis=1, kind="stable")
    final = (order, 1.0 / (1.0 + np.exp(-np.take_along_axis(got, order, axis=1))))
    fused = (np.broadcast_to(np.arange(k), (qn, k)), np.zeros((qn, k)))
    # a corpus of 0 docs: the fused list reads as no list, so fusion (with
    # no legs to recompute it from) is skipped and read as infinite
    readings = judge({"legs": {}, "fused": fused, "final": final}, {}, lambda head: ref, n_docs=0, rerank_depth=k)
    return {name: readings[name] for name in ("rerank.gap", "rerank.err", "rerank.err.median")}


def packed_rows_inputs(torch, np, rng, vocab: int, n_queries: int, depth: int, device) -> tuple:
    """A batch's packed rerank inputs at the benchmark's shape: ``n_queries``
    queries of lognormal word counts (median 14, sigma 0.45) cut at
    PACKED_FA_LQ tokens, each with ``depth`` docs of its own whose lengths
    (lognormal, median PACKED_FA_LD, sigma 0.9, at least 8) half reach the
    PACKED_FA_LD cut, random ids → ``rerank_tokens_packed``'s arguments."""
    lq, ld, n_docs = PACKED_FA_LQ, PACKED_FA_LD, n_queries * depth
    q_lens = np.clip(np.rint(rng.lognormal(np.log(14), 0.45, n_queries)), 4, lq).astype(np.int32)
    doc_lens = np.clip(np.rint(rng.lognormal(np.log(ld), 0.9, n_docs)), 8, ld).astype(np.int32)
    q_mask = (np.arange(lq)[None] < q_lens[:, None]).astype(np.int32)
    d_mask = (np.arange(ld)[None] < doc_lens[:, None]).astype(np.int8)
    q_ids = np.where(q_mask > 0, rng.integers(5, vocab - 1, (n_queries, lq)), 1)
    d_ids = np.where(d_mask > 0, rng.integers(5, min(vocab - 1, 32_767), (n_docs, ld)), 1).astype(np.int16)
    as_dev = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
    head = np.arange(n_docs, dtype=np.int64).reshape(n_queries, depth)
    return as_dev(q_ids), as_dev(q_mask), as_dev(d_ids), as_dev(d_mask), head, doc_lens, q_lens


def packed_fa_check(torch, np, device="cuda", cfg=None, n_queries=BATCH, depth=100, runs=3, seed=23) -> dict:
    """[rerank_packed_fa]: the packed rerank stage at the benchmark's shape
    (a batch of 64 queries' top 100, rows 384 wide, 85 a chunk) with a
    CamemBERT-base cross-encoder (bf16, every matrix, bias and LayerNorm
    shift normal(0, PACKED_FA_STD), gains 1 + the same), its attention on
    FA (the default ``einsum`` form on the card) against the ``einsum``
    chain on the card and an f32 forward of the same weights on the chain:
    the logits' readings against the f32 ones by perfbench's rules
    (``head_readings``) beside its limits, FA's launches (one a layer and
    chunk), each path's stage ms (median of ``runs`` CUDA-event runs, the
    host plan included) and peak memory, FA's device ms a call from queued
    calls on the first chunk's layer-0 operands (so a batch's FA time is
    that times the launches, whether or not a trace holds them), and one
    traced stage on FA (top device operations; the FA launches the trace
    holds a call)."""
    from fusion_tpu_torch.models import encoder
    from fusion_tpu_torch.models.crossencoder import CrossEncoder, CrossEncoderModule
    from fusion_tpu_torch.ops.attention import masked_attention_cuda

    cfg = cfg or encoder.EncoderConfig(dtype=torch.bfloat16)
    max_length = 2 + PACKED_FA_LQ + PACKED_FA_LD
    gen = torch.Generator().manual_seed(seed)
    with torch.device("meta"):
        shapes = CrossEncoderModule(cfg).state_dict()
    params = {}
    for name, w in shapes.items():
        noise = torch.randn(w.shape, generator=gen) * PACKED_FA_STD
        params[name] = 1.0 + noise if name.endswith("ln.weight") else noise
    ce = CrossEncoder(cfg, params=params, max_length=max_length, device=device)
    ce32 = CrossEncoder(dataclasses.replace(cfg, dtype=torch.float32), params=ce.module.state_dict(),
                        max_length=max_length, device=device)
    args = packed_rows_inputs(torch, np, np.random.default_rng(seed), cfg.vocab_size, n_queries, depth, device)
    stage = lambda m=ce: m.rerank_tokens_packed(*args)  # noqa: E731
    first = {}
    real = encoder.masked_attention
    limits = rerank_reading_limits()

    def grab(*a):
        first.setdefault("args", a)
        return real(*a)

    out = {"limits": limits}
    encoder.masked_attention, masked_attention_cuda.launches = grab, 0
    try:
        with torch.inference_mode():
            fa = stage().float()
    finally:
        encoder.masked_attention = real
    with torch.inference_mode():  # the f32 forward keeps the chain (FA serves bf16 packed rows)
        chain = on_einsum_chain(stage).float()
        ref = stage(ce32).float()
    desc, _, width, _, rpc, _ = ce.plan_packed(args[4], args[5], args[6], PACKED_FA_LQ, PACKED_FA_LD,
                                               args[2].shape[0])
    n_rows = int(desc[2].max()) + 1
    out.update(row_width=width, rows=n_rows, rows_per_chunk=rpc, chunks=-(-n_rows // rpc),
               fa_launches=masked_attention_cuda.launches)
    check(out["fa_launches"] == cfg.num_layers * out["chunks"],
          f"rerank_packed_fa: FA launched {out['fa_launches']} times, not once a layer and chunk")
    check(bool(torch.isfinite(fa).all() and torch.isfinite(chain).all()), "rerank_packed_fa: non-finite logits")
    host = lambda t: t.cpu().double().numpy()  # noqa: E731
    out["fa"], out["einsum_chain"] = head_readings(np, host(fa), host(ref)), head_readings(np, host(chain), host(ref))
    out["fa_vs_chain_max_logit_gap"] = (fa - chain).abs().max().item()
    out["ref_logit_spread_median"] = float(np.median(host(ref).max(1) - host(ref).min(1)))
    for path in ("fa", "einsum_chain"):
        over = {k: v for k, v in out[path].items() if v > limits[k]}
        check(not over, f"rerank_packed_fa {path}: readings {over} over perfbench's limits")
    with torch.inference_mode():
        for path, fn in (("fa", stage), ("einsum_chain", lambda: on_einsum_chain(stage))):
            torch.cuda.reset_peak_memory_stats()
            out[f"{path}_stage_ms"] = statistics.median(timed_ms(torch, fn, runs))
            out[f"{path}_peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
        q = first["args"][0]
        out["fa_call_shape"] = list(q.shape)
        out["fa_call_device_ms"], out["fa_queue_full"] = queued_ms(torch, lambda: real(*first["args"]), RUNS)
        out["fa_ms_per_stage"] = out["fa_call_device_ms"] * out["fa_launches"]
        traced = attention_device_ms(torch, stage, runs=1)
        out["traced_fa_launches_per_stage"] = traced.get("fa_forward_kernel_traced_launches", 0.0)
        out["fa_stage_profile"] = stage_profile(torch, stage)
    del ce, ce32
    gc.collect()
    torch.cuda.empty_cache()
    return out


def attention_inputs(torch, searcher, inputs, head):
    """The masked-attention kernel's operands of its first call on a stage:
    layer 0 of ``searcher``'s cross-encoder on one batch's head (its packed
    or flat stage), captured at the attention module's entry → (q, k, v
    views of the fused qkv projection, key mask, segment ids or None)."""
    ce = searcher.cross_encoder
    att = ce.module.encoder.layers[0].attention
    got = {}

    def hook(_, args):
        if not got:
            got["x"], got["mask"], got["seg"] = (None if a is None else a.clone() for a in args[:3])

    handle = att.register_forward_pre_hook(hook)
    try:
        searcher._packed_rerank_stage(inputs, head) if searcher.rerank_packed else \
            searcher._flat_rerank_stage(inputs, head)
    finally:
        handle.remove()
    b, length, hidden = got["x"].shape
    with torch.inference_mode():
        qkv = att.qkv(got["x"]).view(b, length, 3, ce.cfg.num_heads, hidden // ce.cfg.num_heads)
    return (*qkv.unbind(2), got["mask"], got["seg"])


def attention_work(torch, q, mask, seg) -> tuple[float, float]:
    """(operations, bytes) the masked attention of these operands needs: 4 hd
    operations per head for each (query, allowed key) pair, a query with no
    allowed key counting every key of its row (its output averages them);
    q, k, v read and the output written once, the masks as int32."""
    from fusion_tpu_torch.ops.attention import allowed_keys

    b, length, heads, hd = q.shape
    n = allowed_keys(mask, seg).expand(b, 1, length, length).sum(-1)
    pairs = torch.where(n > 0, n, length).sum().item()
    masks = 1 if seg is None else 2
    return 4.0 * hd * heads * pairs, 4.0 * q.numel() * q.element_size() + 4.0 * masks * b * length


def attention_check(torch, searcher, queries, runs, device="cuda") -> dict:
    """[attention]: the masked-attention kernel (``ops/attention``,
    ``csrc/attention.cu``) against its plain version on the operands the
    main path gives it (layer 0 of the flash cross-encoder's first call on
    one batch, packed [128, 256, 12, 64] and flat [512, 256, 12, 64], bf16),
    on one layer's doc call of the ColBERT bench step ([1024, 256, 12, 64]
    bf16, every token real), on a small ragged case with all-pad rows in
    bf16 and f32, and on a query-encoder shape: max |kernel - plain| within
    ATTN_TOL, REPEATS more launches bit-identical; at the packed and the
    bench doc shapes the kernel's and the plain version's CUDA-event times
    (RUNS in turns), its device time from queued calls and in a
    torch.profiler trace, the library call's (scaled_dot_product_attention
    with the same float bias, pinned to the memory-efficient kernel) and
    the bound from the allowed pairs."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from fusion_tpu_torch.ops.attention import allowed_keys, masked_attention_cuda, masked_attention_plain
    from fusion_tpu_torch.tools import bench_maxsim

    inputs = searcher._prepare_inputs(queries[:BATCH])
    head = searcher._fuse(searcher._search_batch(inputs)).ids[:, : searcher.rerank_depth]
    flash = dataclasses.replace(searcher, cross_encoder=searcher.cross_encoder.with_attention("flash"))
    gen = torch.Generator(device=device).manual_seed(41)
    ragged_mask = (torch.arange(70, device=device)[None] < torch.tensor([[70], [33], [0]], device=device)).int()
    ragged_seg = torch.where(torch.arange(70, device=device) < 30, 1, 2)[None].expand(3, 70) * ragged_mask
    cases = {
        "packed": attention_inputs(torch, flash, inputs, head),
        "flat": attention_inputs(torch, dataclasses.replace(flash, rerank_packed=False), inputs, head),
        "query": (*torch.randn((64, 32, 3, 12, 64), generator=gen, device=device).bfloat16().unbind(2),
                  (torch.arange(32, device=device)[None] < torch.randint(4, 33, (64, 1), generator=gen,
                                                                         device=device)).int(), None),
        "bench_doc": (*torch.randn((*BENCH_DOC_SHAPE[:2], 3, *BENCH_DOC_SHAPE[2:]), generator=gen,
                                   device=device).bfloat16().unbind(2),
                      torch.ones(BENCH_DOC_SHAPE[:2], dtype=torch.int32, device=device), None),
    }
    for dtype, tag in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
        qkv = torch.randn((3, 70, 3, 2, 64), generator=gen, device=device).to(dtype)
        cases[f"ragged_{tag}"] = (*qkv.unbind(2), ragged_mask, ragged_seg)
    out, err_max = {}, 0.0
    with torch.inference_mode():
        for name, (q, k, v, mask, seg) in cases.items():
            atol, rtol = ATTN_TOL["bf16" if q.dtype == torch.bfloat16 else "f32"]
            got = masked_attention_cuda(q, k, v, mask, seg, 0.125)
            want = masked_attention_plain(q, k, v, mask, seg, 0.125)
            err = (got.float() - want.float()).abs()
            res = {"shape": list(q.shape), "dtype": str(q.dtype), "segments": seg is not None,
                   "max_abs_err": err.max().item(), "tol": [atol, rtol]}
            check(bool((err <= atol + rtol * want.float().abs()).all()),
                  f"attention {name}: kernel off its plain version by {res['max_abs_err']}")
            res["bit_identical_launches"] = REPEATS + 1
            check(repeat_identical(torch, lambda: masked_attention_cuda(q, k, v, mask, seg, 0.125), got),
                  f"attention {name}: repeated launches differ")
            if q.dtype == torch.bfloat16:
                err_max = max(err_max, res["max_abs_err"])
            if name in ("packed", "bench_doc"):
                res["ms"], res["plain_ms"] = alternating_ms(
                    torch, lambda: masked_attention_cuda(q, k, v, mask, seg, 0.125),
                    lambda: masked_attention_plain(q, k, v, mask, seg, 0.125), runs)
                bias = torch.where(allowed_keys(mask, seg), 0.0, -1e9).to(q.dtype)
                qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
                with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
                    lib = lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=bias, scale=0.125)  # noqa: E731
                    res["library_ms"] = statistics.median(timed_ms(torch, lib, runs))
                flops, nbytes = attention_work(torch, q, mask, seg)
                res["bound_ms"] = bench_maxsim.bound(flops, nbytes)
                res["allowed_share"] = flops / (4.0 * q.shape[-1] * q.shape[2] * q.shape[0] * q.shape[1] ** 2)
                res["tflops_per_s"] = flops / res["ms"] / 1e9
                fa = lambda: masked_attention_cuda(q, k, v, mask, seg, 0.125)  # noqa: E731
                res["device_ms"], res["queue_full"] = queued_ms(torch, fa, runs)
                res["traced"] = attention_device_ms(torch, fa)
                res["share_of_bound"] = res["bound_ms"][0] / res["ms"]
                res["device_share_of_bound"] = res["bound_ms"][0] / res["device_ms"]
                with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
                    res["library_device_ms"] = queued_ms(torch, lib, runs)[0]
            out[name] = res
    del cases
    gc.collect()
    torch.cuda.empty_cache()
    out["max_abs_err"] = err_max
    return out


def top10_overlap(np, a, b) -> float:
    """Mean top-10 overlap of two [Q, k] id arrays."""
    return float(np.mean([len(set(x[:10].tolist()) & set(y[:10].tolist())) / 10 for x, y in zip(a, b)]))


def layerwise_same_form(torch, ce, ids, mask, pos, seg, device="cuda") -> dict:
    """``ce``'s trunk in f32 (the same weights) on the card and on the CPU,
    layer by layer: each layer of a form (``einsum_bf16``, ``flash`` — the
    kernel's f32 body on the card, its plain version on the CPU —, and the
    int8 view) runs on both devices from the same input, the card's output
    of the layer before.  Per layer: the max gap between the two devices
    over the real tokens, against the form's gap to the f32 ``einsum``
    layer on the same input.  ``einsum_bf16`` and int8 must sit nearer
    their own form on the CPU than half their gap to ``einsum`` in every
    layer; ``flash`` is the ``einsum`` arithmetic, so it has no gap and is
    held to SAME_FORM_F32_TOL.  (Whole trunks drift apart: a code or a
    bf16 logit one step off in one layer moves the next layer's codes, so
    12 int8 layers on two devices differ by nearly the int8 error itself.)"""
    from fusion_tpu_torch.models.crossencoder import CrossEncoder

    real = (mask > 0).cpu()
    h_mask, h_seg = mask.cpu(), seg.cpu()
    cfg32 = dataclasses.replace(ce.cfg, dtype=torch.float32)
    params = {k: v.float() for k, v in ce.module.state_dict().items()}
    card = CrossEncoder(cfg32, params=params, max_length=ce.max_length, device=device)
    host = CrossEncoder(cfg32, params={k: v.cpu() for k, v in params.items()}, max_length=ce.max_length,
                        device="cpu")
    out = {"rows": int(ids.shape[0]), "real_tokens": int(real.sum()), "layers": cfg32.num_layers}
    for form in ("einsum_bf16", "flash", "int8"):
        view = (lambda m: m.quantized()) if form == "int8" else (lambda m, f=form: m.with_attention(f))
        c_layers, h_layers = view(card).module.encoder.layers, view(host).module.encoder.layers
        same, gap = [], []
        with torch.inference_mode():
            x = card.module.encoder.embeddings(ids, pos)
            for i, ref_layer in enumerate(card.module.encoder.layers):
                y = c_layers[i](x, mask, seg)
                same.append((y.cpu() - h_layers[i](x.cpu(), h_mask, h_seg)).abs()[real].max().item())
                gap.append((y - ref_layer(x, mask, seg)).abs().cpu()[real].max().item())
                x = y
        limits = [SAME_FORM_F32_TOL] * len(gap) if form == "flash" else [g / 2 for g in gap]
        out[form] = {"card_vs_cpu": same, "gap_vs_einsum": gap,
                     "worst_share_of_limit": max(a / b for a, b in zip(same, limits))}
    for form in ("einsum_bf16", "flash", "int8"):
        check(out[form]["worst_share_of_limit"] <= 1.0,
              f"rerank_forms same form {form}: per-layer card vs CPU {out[form]['card_vs_cpu']} over its "
              f"limits (gap to einsum {out[form]['gap_vs_einsum']})")
    return out


def same_form_check(torch, searcher, inputs, head, rows=SAME_FORM_ROWS, device="cuda") -> dict:
    """[rerank_forms] each form held to itself (``layerwise_same_form``) on
    the first ``rows`` packed rows of one batch's stage, captured at the
    trunk's entry; then the bf16 int8 view's codes of layer 0's output on
    the card, bit-equal to the CPU's, and its qkv product within one bf16
    ulp of the CPU's."""
    from fusion_tpu_torch.models.encoder import int8_codes, int8_linear
    from fusion_tpu_torch.tools.bench_maxsim import bf16_ulp

    ce = searcher.cross_encoder
    got = {}

    def hook(_, args):
        if not got:
            got["args"] = tuple(a[:rows].clone() for a in args[:4])

    handle = ce.module.encoder.register_forward_pre_hook(hook)
    try:
        searcher._packed_rerank_stage(inputs, head)
    finally:
        handle.remove()
    ids, mask, pos, seg = got["args"]
    out = layerwise_same_form(torch, ce, ids, mask, pos, seg, device)
    qce = ce.quantized()
    with torch.inference_mode():
        x = qce.module.encoder.layers[0](qce.module.encoder.embeddings(ids, pos), mask, seg)
        layer = qce.module.encoder.layers[0].attention.qkv
        codes, scales = int8_codes(x)
        h_codes, h_scales = int8_codes(x.cpu())
        y = int8_linear(x, layer.weight, layer.bias).cpu().float()
        h_y = int8_linear(x.cpu(), layer.weight.cpu(), layer.bias.cpu()).float()
    out["int8_codes_bit_equal"] = bool(torch.equal(codes.cpu(), h_codes) and torch.equal(scales.cpu(), h_scales))
    check(out["int8_codes_bit_equal"], "rerank_forms same form int8: the card's codes differ from the CPU's")
    out["int8_qkv_card_vs_cpu"] = (y - h_y).abs().max().item()
    ulp = bf16_ulp(h_y.abs().max()).item()
    check(out["int8_qkv_card_vs_cpu"] <= ulp,
          f"rerank_forms same form int8: qkv product off the CPU's by {out['int8_qkv_card_vs_cpu']} (> {ulp})")
    return out


def rerank_forms_check(torch, np, searcher, queries, device="cuda") -> dict:
    """[rerank_forms]: the main path's searcher (the slice with its
    CamemBERT-width cross-encoder, rerank depth 100) with each other form of
    the rerank stage, on one batch's fused head: the packed and the flat
    stage with ``einsum_bf16`` and ``flash`` attention (``with_attention``),
    the flat cascade at (keep 25, stage1 'auto', resolved to the corpus p90
    length), the length-bucketed stage on ``aligned_buckets``' ladder, and
    the packed stage of the ``quantized`` (int8) cross-encoder.  For each:
    the logits against an f32 ``einsum`` forward of the same weights within
    RERANK_LOGIT_TOL (all valid slots; the cascade's kept ones), the stage's
    time (median of 3 CUDA-event runs, host plan and read-back included)
    and the peak memory over those runs, and the masked-attention kernel's
    launches in the stage (the flash forms and the int8 view's packed rows,
    whose einsum form FA serves on the card: a multiple of the layer count;
    the others: none); then (all but the flat attention forms) a search of
    the first 64 queries with the kernel's count set to 0 just before it and
    read just after: fused output checked, the reranked head the same set as the
    default packed stage's and its top-10 overlap with it.  The packed
    flash logits' gap to the packed ``einsum`` stage (both on FA) is
    reported; ``same_form`` holds each form to itself."""
    from fusion_tpu_torch.core.ranked import stable_topk
    from fusion_tpu_torch.models.crossencoder import CrossEncoder
    from fusion_tpu_torch.ops.attention import masked_attention_cuda
    from fusion_tpu_torch.serving import _resolve_cascade

    ce = searcher.cross_encoder
    depth = searcher.rerank_depth
    # the forms' searches take the first batch (cut from 192 queries to keep
    # the script inside its time limit)
    queries = queries[:BATCH]
    base, _ = searcher.search(queries, batch_size=BATCH)
    base_ids = base.ids.numpy()
    inputs = searcher._prepare_inputs(queries[:BATCH])
    fused = searcher._fuse(searcher._search_batch(inputs))
    head = fused.ids[:, :depth]
    valid = head >= 0
    ce32 = CrossEncoder(dataclasses.replace(ce.cfg, dtype=torch.float32), params=ce.module.state_dict(),
                        max_length=ce.max_length, device=ce.device)
    ref = dataclasses.replace(searcher, cross_encoder=ce32)._packed_rerank_stage(inputs, head)
    del ce32
    packed_einsum = searcher._packed_rerank_stage(inputs, head)
    flat = dataclasses.replace(searcher, rerank_packed=False)
    width = searcher.ce_doc_tokens.shape[1]
    cascade = _resolve_cascade((25, "auto"), searcher.ce_doc_lens, width)
    ladder = ce.aligned_buckets(LQ, width)
    forms = {
        **{f"{stage}_{impl}": (dataclasses.replace(s, cross_encoder=ce.with_attention(impl)), RERANK_LOGIT_TOL)
           for impl in ("einsum_bf16", "flash") for stage, s in (("packed", searcher), ("flat", flat))},
        "cascade": (dataclasses.replace(flat, rerank_cascade=cascade), RERANK_LOGIT_TOL),
        "bucketed": (dataclasses.replace(searcher, rerank_packed=False, rerank_buckets=ladder), RERANK_LOGIT_TOL),
        "packed_int8": (dataclasses.replace(searcher, cross_encoder=ce.quantized()), RERANK_LOGIT_TOL),
    }
    out = {"cascade_setting": cascade, "ladder": ladder}
    kr = min(depth, fused.depth)
    for name, (s, tol) in forms.items():
        # FA serves the flash forms, and the int8 view's packed bf16 rows in
        # the einsum form (models/encoder.packed_on_kernel)
        on_fa = name.endswith("flash") or name == "packed_int8"
        masked_attention_cuda.launches = 0
        if s.rerank_buckets is not None:
            logits = s._bucketed_rerank_stage(inputs, head)
        elif s.rerank_packed:
            logits = s._packed_rerank_stage(inputs, head)
        else:
            logits = s._flat_rerank_stage(inputs, head)
        launches = masked_attention_cuda.launches
        layers = s.cross_encoder.cfg.num_layers
        check(launches > 0 and launches % layers == 0 if on_fa else launches == 0,
              f"rerank_forms {name}: the masked-attention kernel launched {launches} times in the stage")
        check(bool(torch.isfinite(logits).all()), f"rerank_forms {name}: non-finite logits")
        slots = valid
        if name == "cascade":  # the kept slots: the top `keep` (the rest sit below their minimum)
            _, kept = stable_topk(torch.where(valid, logits, -torch.inf), cascade[0])
            slots = torch.zeros_like(valid).scatter_(1, kept, True) & valid
        err = (logits - ref).abs()[slots].max().item()
        res = {"logit_err_vs_f32": err, "tol": tol, "kernel_launches_stage": launches}
        check(err <= tol, f"rerank_forms {name}: logits off the f32 forward by {err} (> {tol})")
        if name == "packed_flash":
            res["logit_gap_vs_packed_einsum"] = (logits - packed_einsum).abs()[valid].max().item()
        torch.cuda.reset_peak_memory_stats()
        res["stage_ms"] = statistics.median(timed_ms(torch, lambda s=s: s._rerank(inputs, fused), 3))
        res["stage_peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
        if not name.startswith("flat_"):
            masked_attention_cuda.launches = 0
            ranked, _ = s.search(queries, batch_size=BATCH)
            res["kernel_launches_search"] = masked_attention_cuda.launches
            check(res["kernel_launches_search"] > 0 if on_fa else res["kernel_launches_search"] == 0,
                  f"rerank_forms {name}: the masked-attention kernel launched "
                  f"{res['kernel_launches_search']} times in the search")
            check_ranked(torch, np, ranked, len(queries), TOPK, N_DOCS)
            ids = ranked.ids.numpy()
            res["head_sets_equal"] = all(set(a[:kr]) == set(b[:kr]) for a, b in zip(ids, base_ids))
            check(res["head_sets_equal"], f"rerank_forms {name}: the reranked head holds other docs")
            res["top10_overlap_vs_packed_einsum"] = top10_overlap(np, ids, base_ids)
        out[name] = res
    out["same_form"] = same_form_check(torch, searcher, inputs, head, device=device)
    return out


def t5_check(torch, np, searcher, queries, device="cuda") -> dict:
    """[t5]: a T5CrossEncoder at the CLI's ``--backbone t5`` widths
    (T5Config(vocab_size=32005): d_model 512, d_kv 64, d_ff 2,048, 6 layers,
    8 heads, 32 buckets, max distance 128; random seeded weights, bf16) as
    the slice's cross-encoder over the same doc tokens, packed and flat on
    one batch's fused head: logits of each against an f32 forward of the
    same weights (within T5_LOGIT_TOL) and against each other, stage times
    (median of 3) and the peak memory over them; then the packed stage's search of the 192 queries (fused output
    checked, the head the same set as the fused one's)."""
    from fusion_tpu_torch.models.t5 import T5Config, T5CrossEncoder

    t5 = T5CrossEncoder(T5Config(vocab_size=SPLADE_VOCAB, dtype=torch.bfloat16), max_length=256, seed=15,
                        device=device)
    t5_32 = T5CrossEncoder(dataclasses.replace(t5.cfg, dtype=torch.float32), params=t5.module.state_dict(),
                           max_length=256, device=device)
    packed = dataclasses.replace(searcher, cross_encoder=t5)
    flat = dataclasses.replace(packed, rerank_packed=False)
    inputs = searcher._prepare_inputs(queries[:BATCH])
    fused = searcher._fuse(searcher._search_batch(inputs))
    head = fused.ids[:, : searcher.rerank_depth]
    valid = head >= 0
    lp = packed._packed_rerank_stage(inputs, head)
    lf = flat._flat_rerank_stage(inputs, head)
    ref = dataclasses.replace(searcher, cross_encoder=t5_32)._packed_rerank_stage(inputs, head)
    check(bool(torch.isfinite(lp).all() and torch.isfinite(lf).all()), "t5: non-finite logits")
    out = {
        "layers": t5.cfg.num_layers, "d_model": t5.cfg.d_model, "heads": t5.cfg.num_heads,
        # T5's attention is its own unscaled form with a position bias: no
        # masked-attention kernel
        "max_abs_logit": lf.abs()[valid].max().item(), "max_logit_gap": (lp - lf).abs()[valid].max().item(),
        "max_logit_err_vs_f32": {"packed": (lp - ref).abs()[valid].max().item(),
                                 "flat": (lf - ref).abs()[valid].max().item()},
    }
    check(max(out["max_logit_err_vs_f32"].values()) <= T5_LOGIT_TOL,
          f"t5: bf16 logits off the f32 forward by {out['max_logit_err_vs_f32']} (> {T5_LOGIT_TOL})")
    for name, s in (("packed", packed), ("flat", flat)):
        torch.cuda.reset_peak_memory_stats()
        out[f"{name}_stage_ms"] = statistics.median(timed_ms(torch, lambda s=s: s._rerank(inputs, fused), 3))
        out[f"{name}_peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    ranked, _ = packed.search(queries, batch_size=BATCH)
    check_ranked(torch, np, ranked, N_QUERIES, TOPK, N_DOCS)
    base = searcher._fuse(searcher._search_batch(inputs)).ids[:, : searcher.rerank_depth].cpu().numpy()
    got = ranked.ids.numpy()[:BATCH, : searcher.rerank_depth]
    out["head_sets_equal"] = all(set(a) == set(b) for a, b in zip(got, base))
    check(out["head_sets_equal"], "t5: the reranked head holds other docs")
    return out


def encoder_forms_check(torch, np, searcher, queries) -> dict:
    """[query_encoders]: the slice's query encoders (DPR, SPLADE, ColBERT)
    swapped for their ``einsum_bf16``, ``flash`` and int8 views
    (``set_encoder_attention`` / ``quantize_encoders``; the indexes keep
    their default-form encoding): per leg, the top-100 overlap of the 192
    queries' lists with the default form's (>= ENCODER_FORM_OVERLAP, int8
    >= ENCODER_INT8_OVERLAP); the legs' time on one batch (median of 3) and
    the peak memory over those runs; the masked-attention kernel's launches
    in the 192 queries' search, the count set to 0 just before it (flash:
    three encoders a batch, one per layer; the others: none)."""
    from fusion_tpu_torch.ops.attention import masked_attention_cuda

    base = searcher.search_systems(queries, batch_size=BATCH, external_ids=False)
    inputs = searcher._prepare_inputs(queries[:BATCH])
    out = {}
    for form in ("einsum", "einsum_bf16", "flash", "int8"):
        s = dataclasses.replace(searcher)
        if form == "int8":
            s.quantize_encoders()
        else:
            s.set_encoder_attention(form)
        torch.cuda.reset_peak_memory_stats()
        res = {"legs_ms": statistics.median(timed_ms(torch, lambda s=s: s._search_batch(inputs), 3)),
               "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
        masked_attention_cuda.launches = 0
        got = s.search_systems(queries, batch_size=BATCH, external_ids=False)
        res["kernel_launches"] = masked_attention_cuda.launches
        check(res["kernel_launches"] > 0 if form == "flash" else res["kernel_launches"] == 0,
              f"query_encoders {form}: the masked-attention kernel launched {res['kernel_launches']} times")
        gate = ENCODER_INT8_OVERLAP if form == "int8" else ENCODER_FORM_OVERLAP
        for leg in ("dpr", "splade", "colbert"):
            res[f"{leg}_top100_overlap"] = overlap100(np, got[leg].ids.numpy(), base[leg].ids.numpy())
            check(res[f"{leg}_top100_overlap"] >= gate,
                  f"query_encoders {form}: {leg} top-100 overlap {res[f'{leg}_top100_overlap']} (< {gate})")
        out[form] = res
    return out


def k4_check(torch, gather_rows, srcs, idx, runs, fresh=()):
    """K4 at one shape: every output byte-equal to the plain gather's (fails
    otherwise); (max |kernel - plain|, {kernel and plain device ms per call,
    from ``runs`` queued back-to-back calls each (``queued_ms``); kernel and
    plain stream ms, medians of ``runs`` alternating CUDA-event runs, host
    calls included}).  The timed calls cycle through ``idx`` and the index
    tensors in ``fresh``, so that rows are not all still in L2."""
    got = gather_rows.gather_rows_cuda(srcs, idx)
    want = gather_rows.gather_rows_plain(srcs, idx)
    torch.cuda.synchronize()
    err = 0.0
    for i, (g, w) in enumerate(zip(got, want)):
        check(g.dtype == w.dtype and g.shape == w.shape and torch.equal(g, w),
              f"K4 source {i} ({w.dtype}, rows {tuple(w.shape[2:])}) differs from the plain gather")
        err = max(err, (g.to(torch.float64) - w.to(torch.float64)).abs().max().item())
    if not runs:
        return err, {}
    pool = (idx, *fresh)
    stream = alternating_ms(
        torch, cycling(lambda i: gather_rows.gather_rows_cuda(srcs, i), pool),
        cycling(lambda i: gather_rows.gather_rows_plain(srcs, i), pool, len(pool) // 2), runs,
    )
    k_ms, k_full = queued_ms(torch, cycling(lambda i: gather_rows.gather_rows_cuda(srcs, i), pool), runs)
    p_ms, p_full = queued_ms(torch, cycling(lambda i: gather_rows.gather_rows_plain(srcs, i), pool), runs)
    return err, {
        "kernel_device_ms": k_ms, "plain_device_ms": p_ms, "queue_full": k_full and p_full,
        "kernel_stream_ms": stream[0], "plain_stream_ms": stream[1],
    }


def k4_ragged(torch, gather_rows, seed=8, n=1000) -> float:
    """K4 at a ragged shape (odd row widths, mixed dtypes, rows 0 and N-1):
    the max |kernel - plain|."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    srcs = (
        torch.randint(0, 2**31 - 1, (n, 7), device="cuda", generator=gen, dtype=torch.int32),
        torch.randint(0, 256, (n, 3), device="cuda", generator=gen, dtype=torch.uint8),
        torch.rand(n, 5, device="cuda", generator=gen),
        torch.randint(0, 256, (n, 4, 32), device="cuda", generator=gen, dtype=torch.uint8),
        torch.rand(n, device="cuda", generator=gen) > 0.5,
    )
    idx = torch.randint(0, n, (5, 37), device="cuda", generator=gen, dtype=torch.int32)
    idx[:, 0], idx[:, 1] = n - 1, 0
    return k4_check(torch, gather_rows, srcs, idx, 0)[0]


def check_ranked(torch, np, ranked, n_queries, topk, n_docs) -> None:
    """Fused output: int32 [Q, k] ids in [0, N) or -1, no duplicates in a
    row, finite scores that never increase along a row."""
    ids, scores = ranked.ids.numpy(), ranked.scores.numpy()
    check(ranked.ids.dtype == torch.int32 and ids.shape == (n_queries, topk), f"ids {ranked.ids.dtype} {ids.shape}")
    check(bool((((ids >= 0) & (ids < n_docs)) | (ids == -1)).all()), "ids out of range")
    check(bool(np.isfinite(scores).all()), "non-finite fused scores")
    check(bool((np.diff(scores, axis=1) <= 0).all()), "fused scores increase along a row")
    check(all(len(set(r[r >= 0])) == (r >= 0).sum() for r in ids), "duplicate ids in a row")


def overlap100(np, a, b) -> float:
    """Mean top-100 overlap of two [Q, k] id arrays (pads excluded)."""
    out = []
    for x, y in zip(a, b):
        x, y = x[:100], y[:100]
        x, y = set(x[x >= 0].tolist()), set(y[y >= 0].tolist())
        out.append(len(x & y) / max(1, len(y)))
    return float(np.mean(out))


def colbert_leg_overlap(torch, np, maxsim, searcher, batch) -> float:
    """Mean top-100 overlap of the ColBERT leg as served (through the kernel
    on the card) with the same leg scored by the plain maxima op."""
    from fusion_tpu_torch.core.ranked import ranked_from_scores

    leg = searcher.search_systems(batch, batch_size=len(batch), external_ids=False)["colbert"]
    inputs = searcher._prepare_inputs(batch)
    mask = inputs["cb_mask"].float()
    q_tok = searcher.colbert_model.embed_tokens(inputs["cb_ids"], inputs["cb_mask"])
    corpus_tm, doc_valid = searcher.colbert_index.prepared()
    maxima = maxsim.maxsim_maxima_plain(q_tok.to(torch.bfloat16).flatten(0, 1), corpus_tm)
    plain = (maxima.view(-1, *mask.shape) * mask[None]).sum(-1).T
    plain = ranked_from_scores(torch.where(doc_valid[None], plain, -torch.inf), leg.depth)
    return overlap100(np, leg.ids.numpy(), plain.ids.cpu().numpy())


def scale_legs_overlap(torch, np, searcher, batch) -> dict[str, float]:
    """Top-100 overlap of the DPR and SPLADE legs as served (through K2 and
    K3) with the same legs through the kernels' plain versions."""
    from fusion_tpu_torch.index.inverted import activations_to_query_terms
    from fusion_tpu_torch.index.sparse import sparse_rescore
    from fusion_tpu_torch.models.heads import l2_normalize
    from fusion_tpu_torch.ops import dense_topk, scatter_score

    legs = searcher.search_systems(batch, batch_size=len(batch), external_ids=False)
    inputs = searcher._prepare_inputs(batch)
    dc, n = searcher.dense_corpus, searcher.dense_n_docs
    q = searcher.dense_model.embed_tokens(inputs["q_ids"], inputs["q_mask"]).float()
    qb = (l2_normalize(q) if dc.normalized else q).to(torch.bfloat16)
    packed = dense_topk.binmax_plain(qb, dc.values, dc.scales, n)
    dpr = dense_topk._select_topk(packed, n, min(searcher.topk, n), 2048)
    sp = searcher.splade_model.embed_tokens(inputs["sp_ids"], inputs["sp_mask"]).float()
    if searcher.splade_model.similarity == "cos_sim":
        sp = l2_normalize(sp)
    terms, weights = activations_to_query_terms(sp, searcher.splade_query_terms)
    idx = searcher.splade_scatter_index
    packed = scatter_score.scatter_binmax_plain(terms, weights, idx.post_doc, idx.post_impact, idx.docs_per_chunk)
    cand = dense_topk._select_topk(packed, idx.n_docs, searcher.splade_rescore_depth, idx.docs_per_chunk)
    splade = sparse_rescore(sp, cand.ids, searcher.splade_rescore_store,
                            k=min(searcher.topk, cand.ids.shape[1]))
    return {
        "dpr": overlap100(np, legs["dpr"].ids.numpy(), dpr.ids.cpu().numpy()),
        "splade": overlap100(np, legs["splade"].ids.numpy(), splade.ids.cpu().numpy()),
    }


def retrievers_check(torch, np, maxsim, searcher, docs, batch) -> dict:
    """Each retriever's own search at top-``TOPK`` over ``batch``, on the
    card, held against the matching leg of ``search_systems`` or against the
    same search on the CPU (top-100 overlap >= 0.99 each): ColBERT.search
    over the token index through both of its branches (K1 launches),
    BiEncoder.search and search_sparse, and BM25Index.search_all (gather,
    matmul), search_dense, search_impact and search_sparse.  Returns the
    overlaps and the K1 launches per ColBERT branch."""
    from fusion_tpu_torch.index.sparse import sparse_search
    from fusion_tpu_torch.models.bm25 import BM25Index
    from fusion_tpu_torch.models.heads import l2_normalize

    legs = searcher.search_systems(batch, batch_size=len(batch), external_ids=False)
    colbert, dense, splade, bm25 = (
        searcher.colbert_model, searcher.dense_model, searcher.splade_model, searcher.bm25
    )
    ids = lambda r: r.ids.cpu().numpy()  # noqa: E731
    out, launches = {}, {}
    for branch, use_pallas in (("prepared", True), ("doc_major", False)):
        before = maxsim.maxsim_maxima_cuda.launches
        ranked = colbert.search(batch, searcher.colbert_index, k=TOPK, batch_size=BATCH, use_pallas=use_pallas)
        launches[f"colbert_{branch}_K1"] = maxsim.maxsim_maxima_cuda.launches - before
        out[f"colbert_{branch}_vs_leg"] = overlap100(np, ids(ranked), ids(legs["colbert"]))
    out["dpr_search_vs_leg"] = overlap100(
        np, ids(dense.search(batch, searcher.dense_corpus, topk=TOPK, batch_size=BATCH)), ids(legs["dpr"])
    )
    sp_index = splade.build_sparse_index(docs, prune_topk=128, batch_size=256)
    card = splade.search_sparse(batch, sp_index, topk=TOPK, batch_size=BATCH)
    q = splade.encode(batch, batch_size=BATCH).float()
    q = l2_normalize(q) if splade.similarity == "cos_sim" else q
    cpu_index = sp_index._replace(entry_term=sp_index.entry_term.cpu(), entry_weight=sp_index.entry_weight.cpu())
    out["splade_search_sparse_vs_cpu"] = overlap100(np, ids(card), ids(sparse_search(q.cpu(), cpu_index, k=TOPK)))
    cpu_bm25 = BM25Index.build(searcher.bm25_preprocess(docs) if searcher.bm25_preprocess else docs,
                               k1=bm25.k1, b=bm25.b, device="cpu")
    exact = cpu_bm25.search_all(batch, top_k=TOPK, method="gather")
    for method in ("gather", "matmul"):
        out[f"bm25_search_all_{method}_vs_cpu"] = overlap100(
            np, ids(bm25.search_all(batch, top_k=TOPK, method=method)), ids(exact)
        )
    out["bm25_search_dense_vs_leg"] = overlap100(
        np, ids(bm25.search_dense(batch, searcher.bm25_impacts, top_k=TOPK)), ids(legs["bm25"])
    )
    impact = bm25.to_impact_index()
    cpu_impact = impact._replace(post_doc=impact.post_doc.cpu(), post_impact=impact.post_impact.cpu())
    out["bm25_search_impact_vs_cpu"] = overlap100(
        np, ids(bm25.search_impact(batch, impact, top_k=TOPK)),
        ids(cpu_bm25.search_impact(batch, cpu_impact, top_k=TOPK)),
    )
    out["bm25_search_sparse_vs_cpu"] = overlap100(
        np, ids(bm25.search_sparse(batch, bm25.to_sparse_index(), top_k=TOPK)),
        ids(cpu_bm25.search_sparse(batch, cpu_bm25.to_sparse_index(), top_k=TOPK)),
    )
    for name, value in out.items():
        check(value >= 0.99, f"retrievers: {name} top-100 overlap {value}")
    for name, value in launches.items():
        check(value > 0, f"retrievers: {name} never launched")
    return {**out, "launches": launches}


def query_tokens(searcher, batch):
    """(ColBERT query tokens f32 [Q, Lq, D], mask f32 [Q, Lq]) of a batch."""
    inputs = searcher._prepare_inputs(batch)
    q_tok = searcher.colbert_model.embed_tokens(inputs["cb_ids"], inputs["cb_mask"])
    return q_tok.float(), inputs["cb_mask"].float()


def compressed_overlaps(torch, np, maxsim, searcher, batch) -> dict[str, float]:
    """On one batch: the exhaustive compressed search (decompress + the
    maxima op, K1 on the card) and ``ColBERT.search``'s compressed branch
    against the same search with the plain maxima op, and the served PLAID
    leg against the exhaustive search."""
    from fusion_tpu_torch.core.ranked import ranked_from_scores
    from fusion_tpu_torch.index.compression import maxsim_search_compressed

    q_tok, mask = query_tokens(searcher, batch)
    index = searcher.colbert_index
    kernel = maxsim_search_compressed(q_tok, mask, index, k=searcher.topk)
    cid_tm, codes_tm, mask_tm, doc_valid = index.prepared()
    corpus_tm = index.decompress_tm(cid_tm, codes_tm, mask_tm)
    maxima = maxsim.maxsim_maxima_plain(q_tok.to(torch.bfloat16).flatten(0, 1), corpus_tm)
    plain = (maxima.view(-1, *mask.shape) * mask[None]).sum(-1).T
    plain = ranked_from_scores(torch.where(doc_valid[None], plain, -torch.inf), kernel.depth)
    plaid = searcher.search_systems(batch, batch_size=len(batch), external_ids=False)["colbert"]
    before = maxsim.maxsim_maxima_cuda.launches
    search = searcher.colbert_model.search(batch, index, k=searcher.topk, batch_size=len(batch))
    return {
        "exhaustive_kernel_vs_plain": overlap100(np, kernel.ids.cpu().numpy(), plain.ids.cpu().numpy()),
        "plaid_vs_exhaustive": overlap100(np, plaid.ids.numpy(), kernel.ids.cpu().numpy()),
        "colbert_search_compressed_vs_plain": overlap100(np, search.ids.cpu().numpy(), plain.ids.cpu().numpy()),
        "colbert_search_compressed_K1": maxsim.maxsim_maxima_cuda.launches - before,
    }


def plaid_leg_vs_plain(torch, np, searcher, batch) -> tuple[float, float]:
    """The PLAID leg as served (candidate rows through K4) against the same
    leg with ``index/plaid.py``'s gather pointed at the plain version for one
    call: (top-100 overlap, max |score diff|)."""
    from fusion_tpu_torch.index import plaid
    from fusion_tpu_torch.ops.gather_rows import gather_rows, gather_rows_cuda, gather_rows_plain

    leg = searcher.search_systems(batch, batch_size=len(batch), external_ids=False)["colbert"]
    launches = gather_rows_cuda.launches
    plaid.gather_rows = gather_rows_plain
    try:
        plain = searcher.search_systems(batch, batch_size=len(batch), external_ids=False)["colbert"]
    finally:
        plaid.gather_rows = gather_rows
    check(gather_rows_cuda.launches == launches, "PLAID leg: the plain-gather search launched K4")
    a, b = leg.scores.numpy(), plain.scores.numpy()
    fin = np.isfinite(b)
    check(bool((np.isfinite(a) == fin).all()), "PLAID leg: the -inf pattern differs kernel vs plain gather")
    diff = float(np.abs(np.where(fin, a - b, 0.0)).max())
    return overlap100(np, leg.ids.numpy(), plain.ids.numpy()), diff


def plaid_breakdown(torch, searcher, batch, runs=3) -> dict:
    """The served ColBERT leg (query encoder + ``plaid_search``) on one
    batch, traced with torch.profiler and the program's spans over ``runs``
    calls: per ``plaid.*`` span of ``index/plaid.py``, the device time (ms per call) of the
    device operations that ran inside the range's device-side span (one
    stream, so exactly those launched inside the range, nested ranges
    included; the gaps between them are not counted); K4's traced device
    time by kernel name, and its traced launches beside its counted ones;
    the whole leg's device time and device operations per call; and its
    stream time (median of ``runs`` CUDA-event runs, host dispatch
    included)."""
    from torch.profiler import ProfilerActivity, profile

    from fusion_tpu_torch.ops.gather_rows import gather_rows_cuda
    from fusion_tpu_torch.utils.profiling import PREFIX, tracing

    inputs = searcher._prepare_inputs(batch)
    leg = lambda: searcher._colbert_leg(inputs)  # noqa: E731
    stream = statistics.median(timed_ms(torch, leg, runs))
    torch.cuda.synchronize()
    launches = gather_rows_cuda.launches
    stage = PREFIX + ".plaid."
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof, tracing():
        for _ in range(runs):
            leg()
        torch.cuda.synchronize()
    launches = (gather_rows_cuda.launches - launches) / runs
    ops = device_events(prof)
    spans = [e for e in prof.events() if e.device_type.name == "CUDA" and e.name.startswith(stage)]
    check(bool(spans), f"PLAID breakdown: the trace holds no device-side span of a {stage}* range")
    out = {}
    for span in spans:
        lo, hi = span.time_range.start, span.time_range.end
        inside = sum(e.self_device_time_total for e in ops if lo <= e.time_range.start and e.time_range.end <= hi)
        key = f"{span.name[len(stage):]}_device_ms"
        out[key] = out.get(key, 0.0) + inside / 1000 / runs
    k4 = [e for e in ops if "gather_rows_kernel" in e.name]
    out["k4_traced_device_ms"] = sum(e.self_device_time_total for e in k4) / 1000 / runs
    out["k4_traced_launches"], out["k4_launches"] = len(k4) / runs, launches
    out["leg_device_ms"] = sum(e.self_device_time_total for e in ops) / 1000 / runs
    out["leg_stream_ms"] = stream
    out["leg_device_ops"] = len(ops) / runs
    check(launches > 0, f"PLAID breakdown: K4 never launched in the served leg: {out}")
    return out


def zipf_corpus(np, n, n_queries, seed=42, vocab=30_000):
    """The synthetic corpus of bench.py: zipf-distributed words t<id>,
    40-160 words per doc; queries of 6 words."""
    rng = np.random.default_rng(seed)
    p = 1.0 / np.arange(1, vocab + 1)
    p /= p.sum()
    lens = rng.integers(40, 160, size=n)
    docs = [" ".join(f"t{t}" for t in rng.choice(vocab, size=length, p=p)) for length in lens]
    queries = [" ".join(f"t{t}" for t in rng.choice(vocab, size=6, p=p)) for _ in range(n_queries)]
    return docs, queries


def small_agreement(torch, np, scale: bool):
    """Tiny f32 searcher on the CPU and on the card from the same seeds
    (``scale``: scale mode with an int8 corpus, K2 and K3 forced)."""
    from fusion_tpu_torch.models.biencoder import BiEncoder
    from fusion_tpu_torch.models.colbert import ColBERT
    from fusion_tpu_torch.models.encoder import EncoderConfig
    from fusion_tpu_torch.serving import HybridSearcher

    docs, queries = zipf_corpus(np, 300, 9, seed=7, vocab=400)
    corpus = dict(enumerate(docs))
    cfg = EncoderConfig.tiny(vocab_size=512)
    opts = dict(
        scale_mode=True, int8_corpus=True, dense_impl="fused", splade_impl="scatter",
        impact_cap=64,
    ) if scale else {}
    out = {}
    for device in ("cpu", "cuda"):
        kw = dict(max_query_length=LQ, max_doc_length=48, device=device)
        searcher = HybridSearcher.build(
            corpus, bm25_docs=docs, topk=20, batch_size=64, device=device,
            dense_model=BiEncoder(cfg, head="dense", seed=1, **kw),
            splade_model=BiEncoder(cfg, head="splade", seed=2, **kw),
            colbert_model=ColBERT(cfg, dim=16, seed=3, **kw), **opts,
        )
        out[device] = searcher.search_systems(queries, batch_size=4)
    worst = 0.0
    for system, ranked in out["cpu"].items():
        a = torch.sort(ranked.scores, dim=1, descending=True).values
        b = torch.sort(out["cuda"][system].scores, dim=1, descending=True).values
        fin = torch.isfinite(a)
        check(bool((fin == torch.isfinite(b)).all()), f"small input: {system} -inf pattern differs")
        err = torch.where(fin, (a - b).abs(), 0.0).max().item()
        check(err <= 1e-2, f"small input: {system} scores differ CPU vs card by {err}")
        worst = max(worst, err)
    return worst


def plaid_small_agreement(torch, np) -> float:
    """A tiny compressed ColBERT searcher whose index and IVF are built once
    on the CPU and copied to the card: PLAID and the exhaustive compressed
    search on the CPU (plain paths) against the card (K4, K1)."""
    from fusion_tpu_torch.models.colbert import ColBERT
    from fusion_tpu_torch.models.encoder import EncoderConfig
    from fusion_tpu_torch.serving import HybridSearcher

    docs, queries = zipf_corpus(np, 300, 9, seed=7, vocab=400)
    cfg = EncoderConfig.tiny(vocab_size=512)
    kw = dict(dim=16, seed=3, max_query_length=LQ, max_doc_length=48)
    cpu = HybridSearcher.build(
        dict(enumerate(docs)), colbert_model=ColBERT(cfg, device="cpu", **kw), topk=20,
        batch_size=64, colbert_compressed=True, colbert_plaid=True, device="cpu",
    )
    card_model = ColBERT(cfg, device="cuda", **kw)
    index, ivf, cpu_ivf = cpu.colbert_index.to("cuda"), cpu.colbert_ivf.to("cuda"), cpu.colbert_ivf
    worst = 0.0
    for name, plaid in (("plaid", True), ("exhaustive", False)):
        cpu.colbert_ivf = cpu_ivf if plaid else None
        card = HybridSearcher(
            corpus_ids=cpu.corpus_ids, colbert_model=card_model, colbert_index=index,
            colbert_ivf=ivf if plaid else None, topk=20, device=torch.device("cuda"),
        )
        a = torch.sort(cpu.search_systems(queries, batch_size=4)["colbert"].scores, dim=1, descending=True).values
        b = torch.sort(card.search_systems(queries, batch_size=4)["colbert"].scores, dim=1, descending=True).values
        fin = torch.isfinite(a)
        check(bool((fin == torch.isfinite(b)).all()), f"plaid_small: {name} -inf pattern differs")
        diff = torch.where(fin, (a - b).abs(), 0.0)
        # the exhaustive search scores f32 query tokens on the CPU (as the JAX
        # package's CPU path does) and bf16 ones on the card (the kernel's
        # input): a relative 2^-9 per token, 2^-8 of the score at most
        allowed = 1e-2 + (0.0 if plaid else 2.0**-8 * a.abs())
        err = diff.max().item()
        check(bool((diff <= allowed).all()), f"plaid_small: {name} scores differ CPU vs card by {err}")
        worst = max(worst, err)
    return worst


def synth_plaid(torch, n=MM_DOCS, gen_seed=31, device="cuda", ch=131_072):
    """The mMARCO-size PLAID index on the card from a seeded generator, at
    bench_mmarco.py's shapes and distributions."""
    from fusion_tpu_torch.index.compression import CompressedTokenIndex
    from fusion_tpu_torch.index.plaid import IVFIndex, dedup_ivf_rows

    gen = torch.Generator(device=device).manual_seed(gen_seed)
    packed = DIM * MM_NBITS // 8
    cid = torch.empty((n, MM_LD), dtype=torch.int32, device=device)
    codes = torch.empty((n, MM_LD, packed), dtype=torch.uint8, device=device)
    for s in range(0, n, ch):
        rows = min(ch, n - s)
        cid[s : s + rows] = torch.randint(0, MM_C, (rows, MM_LD), device=device, generator=gen, dtype=torch.int32)
        codes[s : s + rows] = torch.randint(0, 256, (rows, MM_LD, packed), device=device, generator=gen,
                                            dtype=torch.uint8)
    index = CompressedTokenIndex(
        centroids=torch.randn(MM_C, DIM, device=device, generator=gen) * 0.08,
        centroid_ids=cid, codes=codes,
        mask=torch.ones((n, MM_LD), dtype=torch.uint8, device=device),
        bucket_weights=torch.tensor([-0.04, -0.01, 0.01, 0.04], device=device), nbits=MM_NBITS,
    )
    # duplicate-free lists: the candidate stage's suffix max relies on it
    ivf_doc = dedup_ivf_rows(
        torch.randint(0, n, (MM_C, MM_IVF_CAP), device=device, generator=gen, dtype=torch.int32), n
    )
    ivf = IVFIndex(ivf_doc, n_docs=n, cap=MM_IVF_CAP)
    gb = (index.nbytes() + index.mask.nbytes + ivf.nbytes()) / 1e9
    return index, ivf, gb


def reset_counts(maxsim, dense_topk, scatter_score, gather_rows) -> None:
    maxsim.maxsim_maxima_cuda.launches = 0
    dense_topk.binmax_cuda.launches = dense_topk.binmax_cuda.nomask_launches = 0
    scatter_score.scatter_binmax_cuda.launches = 0
    scatter_score.scatter_pregathered_cuda.launches = 0
    scatter_score.scatter_pregathered_cuda.term_major_launches = 0
    gather_rows.gather_rows_cuda.launches = 0


def counts(maxsim, dense_topk, scatter_score, gather_rows) -> dict[str, int]:
    return {
        "K1": maxsim.maxsim_maxima_cuda.launches,
        "K2": dense_topk.binmax_cuda.launches,
        "K3": scatter_score.scatter_binmax_cuda.launches,
        "K4": gather_rows.gather_rows_cuda.launches,
        "P3": dense_topk.binmax_cuda.nomask_launches,
        "P4": scatter_score.scatter_pregathered_cuda.term_major_launches,
        "P5": scatter_score.scatter_pregathered_cuda.launches,
    }


def warm_timing(torch, searcher, queries, name, smi) -> dict:
    """ms per 64-query batch over 3 warm searches, and the peak memory."""
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    batch_ms = [
        t / (len(queries) // BATCH)
        for t in timed_ms(torch, lambda: searcher.search(queries, batch_size=BATCH), 3)
    ]
    out = dict(
        ms_per_batch_median=statistics.median(batch_ms), ms_per_batch_runs=batch_ms,
        batch=BATCH, gpu=repr(smi), peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30,
    )
    phase(f"{name}_timing", t0, **out)
    return out


def profile_search(torch, searcher, queries, name) -> None:
    """Device busy share of one warm search, and its top kernels."""
    from torch.profiler import ProfilerActivity, profile

    from fusion_tpu_torch.utils.profiling import PREFIX

    t0 = time.perf_counter()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        w0 = time.perf_counter()
        searcher.search(queries, batch_size=BATCH)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - w0) * 1000
    averages = prof.key_averages()
    events = [
        e for e in averages
        if e.device_type.name == "CUDA" and not getattr(e, "is_user_annotation", False)
        and not e.key.startswith(PREFIX + ".")
    ]
    dev_ms = sum(e.self_device_time_total for e in events) / 1000
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:8]
    host = sorted((e for e in averages if e.device_type.name == "CPU"),
                  key=lambda e: -e.self_cpu_time_total)[:8]
    phase(
        f"{name}_profile", t0, wall_ms=wall_ms, device_ms=dev_ms,
        busy_share=dev_ms / wall_ms if wall_ms else None,
        top=[(e.key[:60], round(e.self_device_time_total / 1000, 3)) for e in top],
        top_host=[(e.key[:40], e.count, round(e.self_cpu_time_total / 1000, 3)) for e in host],
    )


def synth_mmarco(torch, np, bm25, gen_seed=21, device="cuda", n=MM_DOCS, ch=131_072):
    """mMARCO-size index arrays on the card from seeded generators (the
    shapes of BENCH_MMARCO_r05.json's serving defaults, the vocabularies of
    the real query side)."""
    from fusion_tpu_torch.index.dense_quant import QuantizedDenseIndex
    from fusion_tpu_torch.index.inverted import ChunkedImpactIndex, ImpactIndex
    from fusion_tpu_torch.index.sparse import SpladeRescoreStore

    gen = torch.Generator(device=device).manual_seed(gen_seed)
    # BM25: cap 2048 over the BM25Index's own V; row V is the sentinel row
    v = bm25.vocab_size
    post_doc = torch.randint(0, n, (v + 1, MM_BM25_CAP), device=device, generator=gen, dtype=torch.int32)
    post_imp = (torch.rand(v + 1, MM_BM25_CAP, device=device, generator=gen) * 2.95 + 0.05).half()
    post_doc[v], post_imp[v] = n, 0.0
    bm25_ii = ImpactIndex(post_doc, post_imp, n_docs=n, vocab_size=v, cap=MM_BM25_CAP,
                          nnz_kept=v * MM_BM25_CAP)
    # DPR: l2-normalized gaussian rows, per-row int8, in chunks
    values = torch.empty((n, MM_H), dtype=torch.int8, device=device)
    scales = torch.empty(n, device=device)
    for s in range(0, n, ch):
        x = torch.randn(ch, MM_H, device=device, generator=gen)
        x = x / x.norm(dim=1, keepdim=True)
        sc = torch.clamp(x.abs().amax(dim=1) / 127.0, min=1e-12)
        values[s : s + ch] = torch.clamp(torch.round(x / sc[:, None]), -127, 127).to(torch.int8)
        scales[s : s + ch] = sc
    dense = QuantizedDenseIndex(values, scales, normalized=True)
    # SPLADE: chunked index over the encoder's vocabulary (row V sentinel)
    vs, c = SPLADE_VOCAB, n // MM_DPC
    sp_doc = torch.randint(0, MM_DPC, (vs + 1, c, MM_CAPC), device=device, generator=gen,
                           dtype=torch.int32).to(torch.int16)
    sp_imp = (torch.rand(vs + 1, c, MM_CAPC, device=device, generator=gen) * 2.95 + 0.05).half()
    sp_doc[vs], sp_imp[vs] = -1, 0.0
    scatter = ChunkedImpactIndex(sp_doc, sp_imp, n_docs=n, docs_per_chunk=MM_DPC, vocab_size=vs,
                                 cap_per_chunk=MM_CAPC, nnz_kept=vs * c * MM_CAPC)
    # the rescore store: K uint16 term ids ++ K f16 weight bits per doc
    packed = torch.empty((n, 2 * MM_STORE_K), dtype=torch.int16, device=device)
    for s in range(0, n, ch):
        terms = torch.randint(0, vs, (ch, MM_STORE_K), device=device, generator=gen, dtype=torch.int32)
        w = (torch.rand(ch, MM_STORE_K, device=device, generator=gen) * 2.95 + 0.05).half()
        packed[s : s + ch, :MM_STORE_K] = terms.to(torch.int16)  # < 32,768: no wrap
        packed[s : s + ch, MM_STORE_K:] = w.view(torch.int16)
    store = SpladeRescoreStore(packed, n_docs=n, vocab_size=vs, prune_topk=MM_STORE_K)
    gb = sum(t.nbytes for t in (post_doc, post_imp, values, scales, sp_doc, sp_imp, packed)) / 1e9
    return bm25_ii, dense, scatter, store, gb


# --- the serving surface: persistence, checkpoints, the CLI, the server ---
# consonants without s, x or y: words of them pass the BM25 preprocessing
# unchanged (no vowel for a stemmer or a suffix rule, no stopword)
_LETTERS = "bcdfghjklmnpqrtvwz"


def letter_word(i: int) -> str:
    """Token ``t<i>`` of the zipf corpus as a word of letters that the
    CLI's BM25 preprocessing leaves as it is."""
    out = "x"
    for _ in range(4):
        i, r = divmod(i, len(_LETTERS))
        out += _LETTERS[r]
    return out


def letter_text(text: str) -> str:
    return " ".join(letter_word(int(t[1:])) for t in text.split())


def dir_bytes(path: str) -> dict[str, int]:
    """Bytes on disk per top-level entry of an index or checkpoint dir."""
    out = {}
    for entry in sorted(os.listdir(path)):
        full = os.path.join(path, entry)
        if os.path.isdir(full):
            out[entry] = sum(os.path.getsize(os.path.join(root, f))
                             for root, _, files in os.walk(full) for f in files)
        else:
            out[entry] = os.path.getsize(full)
    return out


def leg_arrays(torch, searcher) -> dict[str, list]:
    """Per leg, ``(name, tensor, f16_stored)`` of every array the index
    directory persists (f16_stored: the format rounds it through f16)."""
    from fusion_tpu_torch.index.dense_quant import QuantizedDenseIndex

    s = searcher
    legs: dict[str, list] = {}
    if s.bm25 is not None:
        b = s.bm25
        legs["bm25"] = [(n, getattr(b, n), False) for n in ("entry_term", "entry_doc", "entry_tf", "idf", "doc_len")]
        if s.bm25_impact_index is not None:
            legs["bm25"] += [("impact_doc", s.bm25_impact_index.post_doc, False),
                             ("impact_val", s.bm25_impact_index.post_impact, False)]
    for leg, corpus in (("dpr", s.dense_corpus), ("splade", s.splade_corpus)):
        if isinstance(corpus, QuantizedDenseIndex):
            n = (s.dense_n_docs if leg == "dpr" else None) or corpus.values.shape[0]
            legs[leg] = [("values", corpus.values[:n], False), ("scales", corpus.scales[:n], False)]
        elif corpus is not None:
            legs[leg] = [("corpus", corpus, True)]
    if s.splade_scatter_index is not None:
        legs["splade"] = [("scatter_doc", s.splade_scatter_index.post_doc, False),
                          ("scatter_val", s.splade_scatter_index.post_impact, False)]
    if s.splade_impact_index is not None:
        legs["splade"] = [("impact_doc", s.splade_impact_index.post_doc, False),
                          ("impact_val", s.splade_impact_index.post_impact, False)]
    if s.splade_rescore_store is not None:
        legs["splade"].append(("rescore", s.splade_rescore_store.packed, False))
    ci = s.colbert_index
    if ci is not None and hasattr(ci, "tokens"):
        legs["colbert"] = [("tokens", ci.tokens, True), ("mask", ci.mask, False)]
    elif ci is not None:
        legs["colbert"] = [("centroids", ci.centroids, True), ("centroid_ids", ci.centroid_ids, False),
                           ("codes", ci.codes, False), ("mask", ci.mask, False),
                           ("bucket_weights", ci.bucket_weights, False)]
        if s.colbert_ivf is not None:
            legs["colbert"].append(("ivf_doc", s.colbert_ivf.ivf_doc, False))
    if s.ce_doc_tokens is not None:
        legs["monobert"] = [("ce_ids", s.ce_doc_tokens, False), ("ce_mask", s.ce_doc_mask, False)]
    return legs


def rounded_copy(torch, searcher):
    """The searcher with every array that the index directory stores as f16
    rounded through f16, as a reload gives it (the bf16 corpus matrices, the
    token index, the compressed index's centroids)."""
    from fusion_tpu_torch.models.colbert import TokenIndex

    def r16(x):
        return x.to(torch.float16).to(x.dtype) if isinstance(x, torch.Tensor) else x

    ci = searcher.colbert_index
    if isinstance(ci, TokenIndex):
        ci = TokenIndex(tokens=r16(ci.tokens), mask=ci.mask)
    elif ci is not None:
        ci = dataclasses.replace(ci, centroids=r16(ci.centroids), _prepared=None)
    return dataclasses.replace(
        searcher, dense_corpus=r16(searcher.dense_corpus), splade_corpus=r16(searcher.splade_corpus),
        colbert_index=ci,
    )


def persist_check(torch, np, name, searcher, fresh, queries, kernels) -> tuple[dict, object]:
    """Save ``searcher`` to a temporary directory and reload it into
    ``fresh`` (a new searcher with the same models and options): every
    reloaded array equals the in-memory one after the format's own f16
    rounding, and the reloaded searcher's per-leg and fused lists over
    ``queries`` are bit-equal to those of the in-memory searcher with that
    rounding applied, and launch each kernel as often.  Against the
    in-memory searcher itself: legs whose arrays all round-trip exactly are
    bit-equal, the others (and the fused lists) keep a top-100 overlap
    >= 0.99, except PLAID's, whose centroid probe is a discrete choice that
    the f16 centroids move (its overlap is reported).  Returns (the phase's
    fields, the reloaded searcher)."""
    out: dict = {}
    with tempfile.TemporaryDirectory(prefix=f"persist_{name}_") as tmp:
        save_s, load_s = {}, {}
        t0 = time.perf_counter()
        searcher.save_indexes(tmp, timings=save_s)
        out["save_s_total"] = time.perf_counter() - t0
        out["save_s"] = save_s
        out["bytes"] = dir_bytes(tmp)
        t0 = time.perf_counter()
        fresh.load_indexes(tmp, timings=load_s)
        torch.cuda.synchronize()
        out["load_s_total"] = time.perf_counter() - t0
        out["load_s"] = load_s
    want, got = leg_arrays(torch, searcher), leg_arrays(torch, fresh)
    check(sorted(want) == sorted(got), f"persist {name}: legs {sorted(want)} reloaded as {sorted(got)}")
    exact = {}
    for leg, arrays in want.items():
        exact[leg] = True
        for (an, a, f16), (_, b, _) in zip(arrays, got[leg]):
            check(a.shape == b.shape and a.dtype == b.dtype,
                  f"persist {name}: {leg}.{an} {tuple(a.shape)} {a.dtype} reloaded as {tuple(b.shape)} {b.dtype}")
            rounded = a.to(torch.float16).to(a.dtype) if f16 else a
            check(torch.equal(rounded, b), f"persist {name}: {leg}.{an} differs from its stored form")
            exact[leg] = exact[leg] and torch.equal(a, b)
    out["exact_legs"] = exact
    results, launches = {}, {}
    for label, s in (("memory", searcher), ("rounded", rounded_copy(torch, searcher)), ("reloaded", fresh)):
        reset_counts(*kernels)
        fused, _ = s.search(queries, batch_size=BATCH, external_ids=False)
        launches[label] = counts(*kernels)
        results[label] = dict(s.search_systems(queries, batch_size=BATCH, external_ids=False), fused=fused)
    out["launches"] = launches["reloaded"]
    check(launches["memory"] == launches["reloaded"],
          f"persist {name}: launches in memory {launches['memory']}, reloaded {launches['reloaded']}")
    plaid = searcher.colbert_ivf is not None
    per_leg = {}
    for leg, ranked in results["memory"].items():
        other, same_form = results["reloaded"][leg], results["rounded"][leg]
        check(torch.equal(same_form.ids, other.ids) and torch.equal(same_form.scores, other.scores),
              f"persist {name}: the reloaded {leg} lists differ from the in-memory ones over the stored arrays")
        if all(exact.values()) if leg == "fused" else exact.get(leg, True):
            check(torch.equal(ranked.ids, other.ids) and torch.equal(ranked.scores, other.scores),
                  f"persist {name}: the {leg} arrays round-trip exactly but its lists differ")
            per_leg[leg] = "bit-equal"
            continue
        per_leg[leg] = overlap100(np, ranked.ids.numpy(), other.ids.numpy())
        if not (plaid and leg in ("colbert", "fused")):
            check(per_leg[leg] >= 0.99, f"persist {name}: {leg} top-100 overlap {per_leg[leg]}")
    out["lists_vs_memory"] = per_leg
    return out, fresh


def checkpoint_check(torch, np, models, queries, root, device="cuda") -> tuple[dict, dict]:
    """Save each full-width model under ``root`` and load it back (bf16, on
    the card): query encodings and rerank logits bit-equal to the
    originals'.  Returns (the phase's fields, model name → checkpoint dir)."""
    from fusion_tpu_torch.models.encoder import token_tensors

    out, paths = {"save_s": {}, "load_s": {}, "bytes": {}, "bit_equal": {}}, {}
    for name, model in models.items():
        path = os.path.join(root, name)
        t0 = time.perf_counter()
        model.save(path)
        out["save_s"][name] = time.perf_counter() - t0
        out["bytes"][name] = sum(dir_bytes(path).values())
        t0 = time.perf_counter()
        loaded = type(model).load(path, device=device, dtype=model.cfg.dtype)
        torch.cuda.synchronize()
        out["load_s"][name] = time.perf_counter() - t0
        if name == "monobert":
            ids, mask = model.encode_queries_raw(queries[:BATCH], max_query_tokens=32)
            d_ids, d_mask = model.encode_queries_raw(queries[BATCH:2 * BATCH], max_query_tokens=200)
            rows = np.concatenate([ids, d_ids], axis=1), np.concatenate([mask, d_mask], axis=1)
            a = model.score_tokens(*token_tensors(*rows, device))
            b = loaded.score_tokens(*token_tensors(*rows, device))
        else:
            ids, mask = model.text_encoder.encode(queries, query_mode=True)
            a = model.embed_tokens(*token_tensors(ids, mask, device))
            b = loaded.embed_tokens(*token_tensors(ids, mask, device))
        out["bit_equal"][name] = bool(torch.equal(a, b))
        check(out["bit_equal"][name], f"checkpoint {name}: outputs differ after the round trip "
              f"(max {float((a.float() - b.float()).abs().max())})")
        paths[name] = path
        del loaded
    return out, paths


def cli_check(torch, np, docs, queries, paths, root, kernels, device="cuda") -> dict:
    """The CLI in process on a fixture of the slice's first CLI_DOCS docs
    (their words spelled in letters that the BM25 preprocessing keeps), the
    192 queries: serve --task
    build and search with all four retrievers and the rerank, then hybrid
    with percentile-rank NSF over BM25, DPR and ColBERT and hybrid with BM25
    and the rerank, the models from the [checkpoint] directories."""
    from fusion_tpu_torch.cli.main import main as cli_main
    from fusion_tpu_torch.data.preprocessor import TextPreprocessor
    from fusion_tpu_torch.hybrid import run_evaluation
    from fusion_tpu_torch.utils.rankingio import read_ranking_tsv

    docs = docs[:CLI_DOCS]  # the corpus cut to bound the phase's time (mostly the index's save)
    fx_docs = [letter_text(d) for d in docs]
    fx_queries = [letter_text(q) for q in queries]
    prep = TextPreprocessor(spacy_model=None)
    sample = fx_docs[:200] + fx_queries
    check(prep.preprocess(sample) == sample, "cli: the fixture's words do not pass the preprocessing unchanged")
    rng = np.random.default_rng(5)
    gold = rng.integers(0, len(docs), size=len(queries))
    fixture = {
        "corpus": [{"id": 100_000 + i, "article": d, "description": ""} for i, d in enumerate(fx_docs)],
        "questions": {"train": [], "test": [], "dev": [
            {"id": qi, "question": q, "article_ids": [100_000 + int(gold[qi])]} for qi, q in enumerate(fx_queries)
        ]},
    }
    fx_path = os.path.join(root, "fixture.json")
    with open(fx_path, "w") as f:
        json.dump(fixture, f)
    out_dir, idx = os.path.join(root, "out"), os.path.join(root, "index")
    base = ["--fixture", fx_path, "--output_dir", out_dir, "--device", device]
    models = ["--dpr_path", paths["dpr"], "--splade_path", paths["splade"], "--colbert_path", paths["colbert"],
              "--monobert_path", paths["monobert"]]
    systems = ["--run_bm25", "--run_dpr", "--run_splade", "--run_colbert", "--run_monobert"]
    out: dict = {}
    t0 = time.perf_counter()
    built = cli_main(["serve", "--task", "build", "--index_dir", idx, "--batch_size", "256"] + systems + models + base)
    torch.cuda.synchronize()
    out["serve_build_s"] = time.perf_counter() - t0
    out["index_bytes"] = sum(dir_bytes(idx).values())
    reset_counts(*kernels)
    t0 = time.perf_counter()
    cli_main(["serve", "--task", "search", "--index_dir", idx, "--batch_size", str(BATCH)] + systems + models + base)
    out["serve_search_s"] = time.perf_counter() - t0
    out["serve_search_launches"] = counts(*kernels)
    check(out["serve_search_launches"]["K1"] == len(queries) // BATCH,
          f"cli: serve --task search launched K1 {out['serve_search_launches']['K1']} times")
    ranking = read_ranking_tsv(os.path.join(out_dir, "serve_ranking.tsv"))
    check(sorted(ranking) == list(range(len(queries))), f"cli: the ranking TSV has {len(ranking)} queries")
    for qid, pids in ranking.items():
        check(len(set(pids)) == len(pids) and all(100_000 <= p < 100_000 + len(docs) for p in pids),
              f"cli: query {qid}'s ranked ids are out of range or repeated")
    ref, _ = built.search(fx_queries, batch_size=BATCH)
    tsv_ids = np.array([ranking[q][:100] for q in range(len(queries))])
    out["tsv_top100_overlap_vs_built"] = overlap100(np, tsv_ids, ref.ids.numpy()[:, :100])
    check(out["tsv_top100_overlap_vs_built"] >= 0.99, f"cli: TSV vs in-memory overlap {out}")
    del built, ref
    metric_keys = set(run_evaluation([[0]], [[0]], print2console=False))
    for label, argv in (
        ("hybrid_nsf_percentile", ["--run_bm25", "--run_dpr", "--run_colbert", "--fusion", "nsf",
                                   "--normalization", "percentile-rank"]),
        ("hybrid_monobert", ["--run_bm25", "--run_monobert"]),
    ):
        reset_counts(*kernels)
        t0 = time.perf_counter()
        cli_main(["hybrid", "--batch_size", str(BATCH)] + argv + models + base)
        torch.cuda.synchronize()
        out[f"{label}_s"] = time.perf_counter() - t0
        out[f"{label}_launches"] = counts(*kernels)
        with open(os.path.join(out_dir, "performance_hybrid.json")) as f:
            perf = json.load(f)
        check(metric_keys <= set(perf), f"cli: {label} metrics lack {metric_keys - set(perf)}")
        out[f"{label}_recall@100"] = perf["recall@100"]
    check(out["hybrid_nsf_percentile_launches"]["K1"] > 0, "cli: hybrid --run_colbert never launched K1")
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _post(url, payload, timeout=120):
    import urllib.request

    req = urllib.request.Request(url, data=json.dumps(payload).encode(), headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read())


# the HTTP clients of [server], run in a process of their own so that they
# do not share the server's interpreter lock: argv = base url, a JSON file of
# queries, the thread count; prints one JSON object
_CLIENTS = """
import concurrent.futures, json, sys, time, urllib.request
url, path, threads = sys.argv[1], sys.argv[2], int(sys.argv[3])
queries = json.load(open(path))
def one(qi):
    t = time.perf_counter()
    req = urllib.request.Request(url + "/search", data=json.dumps({"queries": [queries[qi]], "topk": 10}).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as r:
        res = json.loads(r.read())["results"][0]
    return qi, res, (time.perf_counter() - t) * 1000
t0 = time.perf_counter()
with concurrent.futures.ThreadPoolExecutor(threads) as pool:
    answers = list(pool.map(one, range(len(queries))))
print(json.dumps({"wall_s": time.perf_counter() - t0, "answers": answers}))
"""


def server_check(torch, np, searcher, queries) -> dict:
    """A SearchServer (127.0.0.1, port 0, max_batch 64) over ``searcher``:
    192 single-query POSTs from 32 client threads (in a process of their
    own), then 3 POSTs of 64 queries, then one malformed body; every answer
    equals the direct search's top-10 ids with scores within 1e-5 (the
    server rounds to 6 decimals), the malformed body gets a 400, and the
    server runs fewer batches than requests."""
    import urllib.error
    import urllib.request

    from fusion_tpu_torch.server import SearchServer

    direct, _ = searcher.search(queries, batch_size=BATCH)
    d_ids, d_scores = direct.ids.numpy(), direct.scores.numpy()

    def agree(qi, res):
        kr = len(res["ids"])
        check(kr == 10 and res["ids"] == d_ids[qi][:kr].tolist(), f"server: query {qi} ids differ from the direct search")
        check(bool(np.abs(np.asarray(res["scores"]) - d_scores[qi][:kr]).max() <= 1e-5),
              f"server: query {qi} scores differ from the direct search")

    t0 = time.perf_counter()
    srv = SearchServer(searcher, host="127.0.0.1", port=0, max_batch=BATCH, max_wait_ms=5.0)
    srv.start()
    out = {"start_s": time.perf_counter() - t0}
    host, port = srv.address
    url = f"http://{host}:{port}"
    try:
        with tempfile.NamedTemporaryFile("w", suffix=".json", delete=False) as f:
            json.dump(list(queries), f)
        try:
            run = subprocess.run([sys.executable, "-c", _CLIENTS, url, f.name, "32"], capture_output=True,
                                 text=True, timeout=600)
        finally:
            os.unlink(f.name)
        check(run.returncode == 0, f"server: the clients failed: {run.stderr[-2000:]}")
        clients = json.loads(run.stdout)
        lat = sorted(a[2] for a in clients["answers"])
        for qi, res, _ in clients["answers"]:
            agree(qi, res)
        out.update(single_requests=len(queries), client_threads=32,
                   requests_per_s=len(queries) / clients["wall_s"], p50_request_ms=lat[len(lat) // 2],
                   p99_request_ms=lat[min(len(lat) - 1, int(0.99 * len(lat)))])
        t0 = time.perf_counter()
        for start in range(0, len(queries), BATCH):
            res = _post(f"{url}/search", {"queries": queries[start:start + BATCH], "topk": 10})
            for j, r in enumerate(res["results"]):
                agree(start + j, r)
        out["batch_request_ms"] = (time.perf_counter() - t0) * 1000 / (len(queries) // BATCH)
        try:
            _post(f"{url}/search", {"queries": [1, 2]})
            fail("server: a malformed body was answered")
        except urllib.error.HTTPError as e:
            check(e.code == 400, f"server: a malformed body got HTTP {e.code}")
        with urllib.request.urlopen(f"{url}/stats", timeout=60) as r:
            stats = json.loads(r.read())
    finally:
        srv.stop()
    check(stats["batches"] < stats["requests"], f"server: {stats['batches']} batches for {stats['requests']} requests")
    out.update(requests=stats["requests"], batches=stats["batches"], mean_batch_ms=stats["mean_batch_ms"],
               errors=stats["errors"])
    return out


# ----------------------------------------------------------------------
# streaming updates, the C++ posting builders, the dataset loaders
# ----------------------------------------------------------------------
SEG_DELTA, SEG_DELETES, SEG_SERVER_ADDS, SEG_SERVER_DELETES = 4_000, 64, 1_000, 32
# [segmented]: the slice's first SEG_DOCS docs, held against a searcher built
# over the same docs (the whole slice's 27,940 before the cut that made room
# for this slice's phases)
SEG_DOCS = 9_970
# [native]'s COO: 2^18 docs x 32 postings (mMARCO's 8.9M docs cut to keep the
# numpy reference builders, and the run, inside its time limit)
NATIVE_DOCS, NATIVE_PER_DOC, NATIVE_BLOCK = 1 << 18, 32, 1_024
READER_RECORDS = 50_000


def segmented_merged(seg, queries) -> dict:
    """Each system's merged (tombstone-stripped) list of a segmented
    searcher, as its search forms them, on the card."""
    from fusion_tpu_torch import segmented

    per = {}
    for s in ([seg.bm25_searcher] if seg.bm25_searcher is not None else []) + seg.segments:
        for name, r in s.search_systems(queries, batch_size=BATCH).items():
            per.setdefault(name, []).append(type(r)(r.ids.to(seg.device), r.scores.to(seg.device)))
    return {n: seg._strip_tombstones(segmented._merge_ranked(p, seg.topk)) for n, p in per.items()}


def without_rerank(seg, fn):
    """``fn()`` with the segmented searcher's cross-encoder stage off (as
    [server] serves the slice without its rerank)."""
    ce, seg.cross_encoder = seg.cross_encoder, None
    try:
        return fn()
    finally:
        seg.cross_encoder = ce


def segmented_timing(torch, seg, queries, kernels, rerank=False) -> tuple[dict, object]:
    """ms per 64-query batch of the segmented searcher (median of 3 warm
    192-query searches; with the flat rerank one) and K1's launches per
    batch; also the last search's lists."""
    last = {}

    def search():
        last["ranked"] = (seg.search(queries, batch_size=BATCH) if rerank else without_rerank(
            seg, lambda: seg.search(queries, batch_size=BATCH)))[0]

    if not rerank:
        search()
    reset_counts(*kernels)
    times = [t / (len(queries) // BATCH) for t in timed_ms(torch, search, 1 if rerank else 3)]
    return {"ms_per_batch": statistics.median(times), "runs": times,
            "K1_per_batch": counts(*kernels)["K1"] / (len(times) * (len(queries) // BATCH))}, last["ranked"]


def segmented_check(torch, np, docs, queries, build_kw, full, kernels) -> tuple[dict, object]:
    """[segmented]: a SegmentedHybridSearcher over the first N - SEG_DELTA
    of ``docs`` with [index]'s build kwargs, then the last SEG_DELTA docs
    added; held against ``full`` (a searcher built over the same docs with
    [index]'s kwargs, no rerank): per-system merged lists, BM25 scores, the
    fused lists and the flat-reranked head; SEG_DELETES top-1 hits deleted,
    then compact."""
    from fusion_tpu_torch import native
    from fusion_tpu_torch.segmented import SegmentedHybridSearcher

    # BM25 rebuilds run the C++ builder; one that does not compile fails here
    t0 = time.perf_counter()
    check(native.get_library() is not None, "segmented: the C++ posting builders did not compile (see the log)")
    out: dict = {"native_load_s": time.perf_counter() - t0, "bm25_builder": "C++ (csrc/bm25_builder.cpp)"}
    n0 = len(docs) - SEG_DELTA
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    seg = SegmentedHybridSearcher(dict(enumerate(docs[:n0])), bm25_docs=docs[:n0], **build_kw)
    torch.cuda.synchronize()
    out["build_s"] = time.perf_counter() - t0
    out["one_segment"] = segmented_timing(torch, seg, queries, kernels)[0]
    t0 = time.perf_counter()
    seg.add_documents({i: docs[i] for i in range(n0, len(docs))}, bm25_docs=docs[n0:])
    torch.cuda.synchronize()
    out["add_s"] = time.perf_counter() - t0
    out["add_bm25_rebuild_s"], out["add_encode_s"] = seg.build_seconds["bm25"], seg.build_seconds["segment"]
    check(len(seg.segments) == 2 and seg.n_docs == len(docs), f"segmented: {len(seg.segments)} segments")

    # the two-segment searcher against the full one
    merged = segmented_merged(seg, queries)
    want = full.search_systems(queries, batch_size=BATCH)
    check(set(merged) == set(want), f"segmented: systems {sorted(merged)} vs {sorted(want)}")
    out["top100_overlap_vs_full"] = {s: overlap100(np, merged[s].ids.cpu().numpy(), want[s].ids.numpy())
                                     for s in want}
    for s, v in out["top100_overlap_vs_full"].items():
        check(v >= 0.99, f"segmented: the {s} leg's top-100 overlap with the full searcher {v}")
    g_ids, g_sc = merged["bm25"].ids.cpu().numpy()[:, :100], merged["bm25"].scores.cpu().numpy()[:, :100]
    w_ids, w_sc = want["bm25"].ids.numpy()[:, :100], want["bm25"].scores.numpy()[:, :100]
    worst = 0.0
    for qi in range(len(queries)):
        w_at = dict(zip(w_ids[qi].tolist(), w_sc[qi].tolist()))
        for i, s in zip(g_ids[qi].tolist(), g_sc[qi].tolist()):
            if i in w_at and np.isfinite(s):
                worst = max(worst, abs(s - w_at[i]) / max(abs(w_at[i]), 1e-12))
    out["bm25_max_rel_diff_at_shared_ids"] = worst
    check(worst <= 1e-5, f"segmented: BM25 scores at shared ids differ by {worst} (idf must be global)")
    reset_counts(*kernels)
    fused, _ = without_rerank(seg, lambda: seg.search(queries, batch_size=BATCH))
    out["search_launches"] = counts(*kernels)
    check(out["search_launches"]["K1"] == 2 * (len(queries) // BATCH),
          f"segmented: K1 launched {out['search_launches']['K1']} times for two segments")
    check_ranked(torch, np, fused, len(queries), TOPK, len(docs))
    out["two_segments"] = segmented_timing(torch, seg, queries, kernels)[0]
    out["flat_rerank"], reranked = segmented_timing(torch, seg, queries, kernels, rerank=True)
    kr = seg.rerank_depth
    for qi in range(len(queries)):
        check(set(reranked.ids.numpy()[qi, :kr].tolist()) == set(fused.ids.numpy()[qi, :kr].tolist()),
              f"segmented: query {qi}'s reranked head is not a permutation of its fused head")

    # deletes: SEG_DELETES distinct top-1 (then top-2, ...) hits
    victims: list[int] = []
    for col in range(TOPK):
        for i in fused.ids.numpy()[:, col].tolist():
            if i >= 0 and i not in victims and len(victims) < SEG_DELETES:
                victims.append(i)
        if len(victims) == SEG_DELETES:
            break
    t0 = time.perf_counter()
    seg.delete_documents(victims)
    torch.cuda.synchronize()
    out["delete_s"] = time.perf_counter() - t0
    after, _ = without_rerank(seg, lambda: seg.search(queries, batch_size=BATCH))
    a_ids, a_sc = after.ids.numpy(), after.scores.numpy()
    check(not (set(a_ids.ravel().tolist()) & set(victims)), "segmented: a deleted doc came back")
    for qi in range(len(queries)):
        row = a_sc[qi][np.isfinite(a_sc[qi])]
        check(bool((np.diff(row) <= 0).all()), f"segmented: query {qi}'s scores increase after the delete")
    t0 = time.perf_counter()
    seg.compact()
    torch.cuda.synchronize()
    out["compact_s"] = time.perf_counter() - t0
    check(len(seg.segments) == 1 and seg.n_docs == len(docs) - SEG_DELETES,
          f"segmented: after compact {len(seg.segments)} segments, n_docs {seg.n_docs}")
    compacted, _ = without_rerank(seg, lambda: seg.search(queries, batch_size=BATCH))
    out["n_docs_after_compact"] = seg.n_docs
    out["top100_overlap_compact_vs_tombstoned"] = overlap100(np, compacted.ids.numpy(), a_ids)
    check(out["top100_overlap_compact_vs_tombstoned"] >= 0.99, f"segmented: compact moved the lists {out}")
    out["after_compact"] = segmented_timing(torch, seg, queries, kernels)[0]
    check(out["two_segments"]["K1_per_batch"] == 2 and out["after_compact"]["K1_per_batch"] == 1,
          f"segmented: K1 per batch {out['two_segments']['K1_per_batch']} / {out['after_compact']['K1_per_batch']}")
    out["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2**30
    return out, seg


# the clients of [segmented_server]: argv = base url, a JSON file of queries,
# the thread count, seconds between a thread's requests; prints one JSON
# object with (query, answer, ms, wall-clock start) per request
_PACED_CLIENTS = """
import concurrent.futures, json, sys, time, urllib.request
url, path, threads, pause = sys.argv[1], sys.argv[2], int(sys.argv[3]), float(sys.argv[4])
queries = json.load(open(path))
def one(qi):
    t, wall = time.perf_counter(), time.time()
    req = urllib.request.Request(url + "/search", data=json.dumps({"queries": [queries[qi]], "topk": 10}).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=300) as r:
        res = json.loads(r.read())["results"][0]
    return qi, res, (time.perf_counter() - t) * 1000, wall
def worker(w):
    got = []
    for qi in range(w, len(queries), threads):
        got.append(one(qi))
        time.sleep(pause)
    return got
t0 = time.perf_counter()
with concurrent.futures.ThreadPoolExecutor(threads) as pool:
    answers = [a for part in pool.map(worker, range(threads)) for a in part]
print(json.dumps({"wall_s": time.perf_counter() - t0, "answers": answers}))
"""


def segmented_server_check(torch, np, seg, queries) -> dict:
    """[segmented_server]: the segmented searcher (its rerank stage off, as
    [server]) behind a SearchServer; 192 single-query requests from 32
    client threads, paced over ~9 s, while SEG_SERVER_ADDS new docs are
    added and SEG_SERVER_DELETES served top-1 hits deleted; /healthz after
    each update, no failed request, no deleted id in an answer to a
    request sent after its delete returned."""
    import urllib.request

    from fusion_tpu_torch.server import SearchServer

    def healthz(url):
        with urllib.request.urlopen(f"{url}/healthz", timeout=60) as r:
            return json.loads(r.read())

    new_docs, _ = zipf_corpus(np, SEG_SERVER_ADDS, 0, seed=77)
    start_id = max(max(c) for c in seg._corpora) + 1
    delta = {start_id + i: d for i, d in enumerate(new_docs)}
    ce, seg.cross_encoder = seg.cross_encoder, None
    direct, _ = seg.search(queries, batch_size=BATCH)
    victims = list(dict.fromkeys(direct.ids.numpy()[:, 0].tolist()))[:SEG_SERVER_DELETES]
    out: dict = {"segments_before_add": len(seg.segments)}
    srv = SearchServer(seg, host="127.0.0.1", port=0, max_batch=BATCH, max_wait_ms=5.0)
    srv.start()
    host, port = srv.address
    url = f"http://{host}:{port}"
    try:
        with tempfile.NamedTemporaryFile("w", suffix=".json", delete=False) as f:
            json.dump(list(queries), f)
        try:
            clients = subprocess.Popen([sys.executable, "-c", _PACED_CLIENTS, url, f.name, "32", "1.5"],
                                       stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            time.sleep(1.0)
            n0 = healthz(url)["corpus_docs"]
            t0 = time.perf_counter()
            seg.add_documents(delta, bm25_docs=new_docs)
            out["add_s"] = time.perf_counter() - t0
            out["segments_after_add"] = len(seg.segments)
            out["healthz_after_add"] = healthz(url)["corpus_docs"]
            check(out["healthz_after_add"] == n0 + SEG_SERVER_ADDS == seg.n_docs,
                  f"segmented_server: /healthz {out['healthz_after_add']} after adding to {n0}")
            t0 = time.perf_counter()
            seg.delete_documents(victims)
            deleted_at = time.time()
            out["delete_s"] = time.perf_counter() - t0
            out["healthz_after_delete"] = healthz(url)["corpus_docs"]
            check(out["healthz_after_delete"] == n0 + SEG_SERVER_ADDS - SEG_SERVER_DELETES,
                  f"segmented_server: /healthz {out['healthz_after_delete']} after the delete")
            stdout, stderr = clients.communicate(timeout=600)
        finally:
            os.unlink(f.name)
        check(clients.returncode == 0, f"segmented_server: a request failed: {stderr[-2000:]}")
        answers = json.loads(stdout)["answers"]
        check(len(answers) == len(queries), f"segmented_server: {len(answers)} answers")
        later = [res for _, res, _, wall in answers if wall > deleted_at]
        check(bool(later), "segmented_server: no request was sent after the delete returned")
        check(not any(set(res["ids"]) & set(victims) for res in later),
              "segmented_server: a deleted id was served after its delete returned")
        lat = sorted(a[2] for a in answers)
        out.update(requests=len(answers), requests_after_delete=len(later), client_threads=32,
                   wall_s=json.loads(stdout)["wall_s"], p50_request_ms=lat[len(lat) // 2],
                   p99_request_ms=lat[min(len(lat) - 1, int(0.99 * len(lat)))],
                   requests_per_s=len(answers) / json.loads(stdout)["wall_s"])
        with urllib.request.urlopen(f"{url}/stats", timeout=60) as r:
            stats = json.loads(r.read())
        out.update(batches=stats["batches"], errors=stats["errors"])
        check(stats["errors"] == 0, f"segmented_server: {stats['errors']} errors")
    finally:
        srv.stop()
        seg.cross_encoder = ce
    return out


def native_check(np, docs) -> dict:
    """[native]: the C++ builders against the numpy ones, byte for byte:
    BM25 postings over the slice's corpus, and both impact packers on a
    seeded COO of NATIVE_DOCS docs x NATIVE_PER_DOC postings (slot j of a doc
    draws a zipf term of block j of NATIVE_BLOCK terms, so (term, doc) pairs
    are unique; impacts follow a random permutation of the docs, so they are
    distinct within a term and no tie meets a cap)."""
    from fusion_tpu_torch import native
    from fusion_tpu_torch.index import inverted
    from fusion_tpu_torch.models import bm25 as bm25_mod

    out: dict = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_native_") as tmp:
        t0 = time.perf_counter()
        native.build_library(tmp)
        out["gxx_build_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    got = native.build_bm25_postings(docs)
    out["bm25_native_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    want = bm25_mod._numpy_postings(docs)
    out["bm25_numpy_s"] = time.perf_counter() - t0
    check(got[0] == want[0], "native: BM25 vocabularies differ")
    for name, g, w in zip(("entry_term", "entry_doc", "entry_tf", "doc_len", "df"), got[1:], want[1:]):
        check(g.shape == w.shape and np.array_equal(g, w.astype(g.dtype)), f"native: BM25 {name} differs")
    out["bm25_postings"] = int(got[1].size)

    rng = np.random.default_rng(41)
    p = 1.0 / np.arange(1, NATIVE_BLOCK + 1)
    term = (rng.choice(NATIVE_BLOCK, size=(NATIVE_DOCS, NATIVE_PER_DOC), p=p / p.sum())
            + np.arange(NATIVE_PER_DOC) * NATIVE_BLOCK).ravel()
    doc = np.repeat(np.arange(NATIVE_DOCS, dtype=np.int64), NATIVE_PER_DOC)
    imp = ((rng.permutation(NATIVE_DOCS) + 1).astype(np.float32) / NATIVE_DOCS)[doc]
    vocab = NATIVE_BLOCK * NATIVE_PER_DOC
    out["postings"] = int(term.size)
    with warnings.catch_warnings():  # the zipf head terms pass the caps, as intended
        warnings.simplefilter("ignore", inverted.ImpactCapTruncationWarning)
        for label, run_native, run_numpy in (
            ("chunked_dpc32768_capc64",
             lambda: native.pack_chunked_impact(term, doc, imp, vocab, NATIVE_DOCS, 32_768, 64),
             lambda: inverted.build_chunked_impact_index(term, doc, imp, vocab, NATIVE_DOCS, 32_768, 64, False,
                                                         device="cpu")),
            ("flat_cap4096",
             lambda: native.pack_flat_impact(term, doc, imp, vocab, NATIVE_DOCS, 4096),
             lambda: inverted.build_impact_index(term, doc, imp, vocab, NATIVE_DOCS, 4096, False, device="cpu")),
        ):
            t0 = time.perf_counter()
            post_doc, post_imp, kept = run_native()
            native_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            ref = run_numpy()
            numpy_s = time.perf_counter() - t0
            ref_doc = ref.post_doc.numpy()
            ref_doc = ref_doc.view(np.uint16) if post_doc.dtype == np.uint16 else ref_doc
            check(kept == ref.nnz_kept and post_doc.tobytes() == ref_doc.tobytes()
                  and post_imp.tobytes() == ref.post_impact.numpy().tobytes(), f"native: {label} arrays differ")
            out[label] = {"native_s": native_s, "numpy_s": numpy_s, "speedup": numpy_s / native_s, "kept": kept}
    return out


def reader_check(np) -> dict:
    """MmarcoReader.sample_from_hard_negatives over READER_RECORDS seeded
    synthetic records (1-3 positives, 8 negatives over two systems, CE
    scores for every pid of a record), 4 negatives per query, tuple format."""
    from fusion_tpu_torch.data.mmarco import MmarcoReader

    rng = np.random.default_rng(17)
    n_pass = READER_RECORDS * 20
    pos = rng.integers(0, n_pass, size=(READER_RECORDS, 3))
    neg = rng.integers(0, n_pass, size=(READER_RECORDS, 8))
    n_pos = rng.integers(1, 4, size=READER_RECORDS)
    score = rng.uniform(0.0, 12.0, size=(READER_RECORDS, 8))
    records, ce = [], {}
    for q in range(READER_RECORDS):
        pp, nn = pos[q, :n_pos[q]].tolist(), neg[q].tolist()
        records.append({"qid": q, "pos": pp, "neg": {"bm25": nn[:4], "msmarco-MiniLM-L-6-v3": nn[4:]}})
        ce[q] = {**dict(zip(nn, score[q].tolist())), **{p: 15.0 for p in pp}}
    corpus = {p: f"passage {p}" for p in range(n_pass)}
    reader = MmarcoReader("fr", corpus, {q: f"question {q}" for q in range(READER_RECORDS)},
                          max_train_examples=READER_RECORDS, training_sample_format="tuple", negs_type="hard",
                          negs_per_query=4)
    t0 = time.perf_counter()
    samples = reader.sample_from_hard_negatives(records, ce)
    s = time.perf_counter() - t0
    check(len(samples) == READER_RECORDS and all(len(x) == 6 for x in samples), "reader: wrong samples")
    return {"records": READER_RECORDS, "samples": len(samples), "sample_s": s, "records_per_s": READER_RECORDS / s}


def cli_datasets_check(torch, np, docs, queries, root, kernels, device="cuda") -> dict:
    """[cli_datasets]: the CLI in process on a fixture in MmarcoLoader's raw
    schema written from the slice's first CLI_DOCS docs (consonant words,
    which the BM25 preprocessing keeps), 128 train and 64 dev questions:
    bm25 --task evaluate --dataset mmarco-fr; colbert --task train --dataset
    mmarco-fr --steps 2 then --task test (K1 counted); dpr --task train
    --dataset mrtydi-ja --steps 2 then --task test; the models at --tiny."""
    from fusion_tpu_torch.cli.main import main as cli_main

    docs = [letter_text(d) for d in docs[:CLI_DOCS]]
    qs = [letter_text(q) for q in queries]
    rng = np.random.default_rng(8)
    gold = rng.integers(0, len(docs), size=len(qs))
    train, dev = range(0, 128), range(128, len(qs))
    fixture = {
        "corpus": {str(i): d for i, d in enumerate(docs)},
        "train_queries": {str(q): qs[q] for q in train},
        "train_qrels": {str(q): [int(gold[q])] for q in train},
        "dev_queries": {str(q): qs[q] for q in dev},
        "dev_qrels": {str(q): [int(gold[q])] for q in dev},
        "negatives": {str(q): rng.integers(0, len(docs), size=3).tolist() for q in train},
    }
    fx = os.path.join(root, "mmarco_fixture.json")
    with open(fx, "w") as f:
        json.dump(fixture, f)
    out: dict = {}
    runs = (
        ("bm25_mmarco", ["bm25", "--task", "evaluate", "--dataset", "mmarco-fr"], "performance_bm25_mmarco-fr_dev.json"),
        ("colbert_mmarco_train", ["colbert", "--task", "train", "--dataset", "mmarco-fr", "--steps", "2",
                                  "--train_batch_size", "8"], None),
        ("colbert_mmarco_test", ["colbert", "--task", "test", "--dataset", "mmarco-fr", "--split", "dev"],
         "performance_colbert.json"),
        ("dpr_mrtydi_train", ["dpr", "--task", "train", "--dataset", "mrtydi-ja", "--steps", "2",
                              "--train_batch_size", "8"], None),
        ("dpr_mrtydi_test", ["dpr", "--task", "test", "--dataset", "mrtydi-ja", "--split", "dev"],
         "ir_eval_results.csv"),
    )
    for label, argv, metrics in runs:
        family = argv[0]
        out_dir = os.path.join(root, f"{family}_{argv[4]}")
        extra = ["--model_path", os.path.join(out_dir, "final")] if argv[2] == "test" and family != "bm25" else []
        reset_counts(*kernels)
        t0 = time.perf_counter()
        cli_main(argv + extra + ["--fixture", fx, "--output_dir", out_dir, "--tiny", "--device", device])
        torch.cuda.synchronize()
        out[label] = {"s": time.perf_counter() - t0, "K1": counts(*kernels)["K1"]}
        if metrics:
            check(os.path.isfile(os.path.join(out_dir, metrics)), f"cli_datasets {label}: no {metrics}")
        else:
            check(os.path.isdir(os.path.join(out_dir, "final")), f"cli_datasets {label}: no final/")
    with open(os.path.join(root, "bm25_mmarco-fr", "performance_bm25_mmarco-fr_dev.json")) as f:
        out["bm25_mmarco"]["recall@100"] = json.load(f)["recall@100"]
    check(out["colbert_mmarco_test"]["K1"] > 0, "cli_datasets: colbert --task test never launched K1")
    gc.collect()
    torch.cuda.empty_cache()
    return out


# ----------------------------------------------------------------------
# the quality and measurement tools of fusion_tpu_torch/tools/
# ----------------------------------------------------------------------
# [lleqa_parity] (a): the 24-article fixture of the JAX package's harness test
LLEQA_TINY = {
    "corpus": [{"id": i + 1, "article": f"article de loi numéro {i} portant sur le sujet {i % 5}"}
               for i in range(24)],
    "questions": {"train": [{"id": 1, "question": "sujet 0 article", "article_ids": [1, 6]}],
                  "dev": [{"id": 2, "question": "article de loi numéro 3", "article_ids": [4]},
                          {"id": 3, "question": "le sujet 2 de loi", "article_ids": [3, 8]}],
                  "test": []},
    "negatives": None,
}
# (b): articles (4,096 before the cut that made room for [examples],
# [tpu_tests] and [chunked_impact]), dev questions, words a document (the
# models read 512 tokens of it)
LLEQA_ARTICLES, LLEQA_DEV, LLEQA_WORDS = 1_024, 64, 512
# card vs CPU: a query's lists may differ only inside runs of CPU scores this
# close (relative to the row's largest |score|): one bf16 rounding of the
# query, two for ColBERT, whose token index is bf16 on the card
BF16_TIE = 2.0**-8
# the card's fusion and rerank against the CPU's of the same lists: f32 sums
# in another order
F32_TIE = 1e-5
# [recall_study]'s cut of the tool's defaults (1,048,576 / 262,144 docs;
# 262,144 / 65,536 before the cut that made room for this slice's phases)
RECALL_DOCS, RECALL_COLBERT_DOCS = 65_536, 16_384
ROOFLINE_BATCHES, ROOFLINE_GROUPS, ROOFLINE_PER = (32, 64, 128, 256), 3, 4


def host_rss_gib() -> float:
    """This process's peak resident memory on the host (GiB)."""
    import resource

    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20


def lleqa_fixture(np, n_articles: int, n_dev: int, words: int, seed: int = 5) -> dict:
    """LLeQA's record format filled with French-like text: each article
    ``words`` words, seven in eight inflected forms of the preprocessor
    study's inventory and stopwords (zipf popularity), one in eight from
    20,000 rarer syllable-built terms (uniform), so that a question can name
    its articles; each dev question 6 rare and 2 common words of one or two
    gold articles."""
    from fusion_tpu_torch.tools.preprocessor_study import FILLER_STOPWORDS, build_inventory

    rng = np.random.default_rng(seed)
    common = [f for lemma in build_inventory() for f in lemma] + FILLER_STOPWORDS
    syllables = [c + v for c in "bcdfglmnprstv" for v in "aeiou"]
    rare = sorted({"".join(rng.choice(syllables, size=3)) for _ in range(30_000)})[:20_000]
    p = 1.0 / np.arange(1, len(common) + 1) ** 0.8
    p /= p.sum()
    n_rare = words // 8
    common_picks = rng.choice(len(common), size=(n_articles, words - n_rare), p=p)
    rare_picks = rng.choice(len(rare), size=(n_articles, n_rare))
    articles = []
    for c_row, r_row in zip(common_picks, rare_picks):
        row = [common[j] for j in c_row] + [rare[j] for j in r_row]
        rng.shuffle(row)
        articles.append(" ".join(row))

    def question(qid):
        gold = rng.choice(n_articles, size=int(rng.integers(1, 3)), replace=False)
        text = [rare[j] for g in gold for j in rng.choice(rare_picks[g], size=6 // len(gold), replace=False)]
        text += [common[j] for j in rng.choice(common_picks[gold[0]], size=2, replace=False)]
        return {"id": qid, "question": " ".join(text), "article_ids": [int(g) + 1 for g in gold]}

    return {"corpus": [{"id": i + 1, "article": a, "description": ""} for i, a in enumerate(articles)],
            "questions": {"train": [], "dev": [question(q) for q in range(n_dev)], "test": []},
            "negatives": None}


def lleqa_checkpoints(root: str, cfg, q_len: int, d_len: int, ce_len: int, dim: int, device) -> dict:
    """DPR, SPLADE, ColBERT and monoBERT at ``cfg``, seeded, saved by the
    port under ``root``."""
    from fusion_tpu_torch.models.biencoder import BiEncoder
    from fusion_tpu_torch.models.colbert import ColBERT
    from fusion_tpu_torch.models.crossencoder import CrossEncoder

    kw = dict(max_query_length=q_len, max_doc_length=d_len, device=device)
    paths = {}
    for i, (name, build) in enumerate((
        ("dpr", lambda s: BiEncoder(cfg, head="dense", seed=s, **kw)),
        ("splade", lambda s: BiEncoder(cfg, head="splade", seed=s, **kw)),
        ("colbert", lambda s: ColBERT(cfg, dim=dim, seed=s, **kw)),
        ("monobert", lambda s: CrossEncoder(cfg, max_length=ce_len, seed=s, device=device)),
    )):
        paths[name] = os.path.join(root, name)
        model = build(31 + i)
        model.save(paths[name])
        del model
    return paths


def lists_agree(np, got, want, rel_tol: float) -> tuple[bool, bool]:
    """(agree, through ties): ``got``'s ranked lists equal ``want``'s, or
    differ only inside runs of ``want``'s scores within ``rel_tol`` × the
    row's largest |score| of each other (the run reaching the depth cut held
    to its scores only), with every score within that of ``want``'s."""
    g_ids, w_ids = got.ids.cpu().numpy(), want.ids.cpu().numpy()
    g_sc, w_sc = got.scores.float().cpu().numpy(), want.scores.float().cpu().numpy()
    if np.array_equal(g_ids, w_ids):
        return True, False
    for row in range(w_ids.shape[0]):
        fin = np.isfinite(w_sc[row])
        tol = rel_tol * max(1.0, float(np.abs(w_sc[row][fin]).max(initial=0.0)))
        if not np.allclose(np.where(fin, g_sc[row], 0), np.where(fin, w_sc[row], 0), atol=tol, rtol=0):
            return False, True
        s, start = w_sc[row], 0
        for end in range(1, len(s) + 1):
            if end == len(s) or not abs(s[end] - s[end - 1]) <= tol:
                if end < len(s) and set(g_ids[row, start:end]) != set(w_ids[row, start:end]):
                    return False, True
                start = end
    return True, True


def on_host(lists):
    """``lists`` (a ``RankedLists``) on the CPU."""
    from fusion_tpu_torch.core.ranked import RankedLists

    return RankedLists(lists.ids.cpu(), lists.scores.cpu())


def lleqa_parity_check(torch, np, root: str, kernels) -> dict:
    """[lleqa_parity]: tools/run_lleqa_parity.py (a) on the JAX package's
    tiny fixture with tiny port-saved checkpoints, on the card and on the
    CPU: every leg's lists and metrics equal the CPU's, the card's fusion
    those of the CPU's fusion of the card's legs, its rerank those of the
    CPU's rerank of its fused lists, but where a query's scores tie within
    the bf16 rounding (F32_TIE for the fusion and the rerank; counted); (b)
    at CamemBERT-base width in bf16 on a synthetic LLeQA of LLEQA_ARTICLES articles and LLEQA_DEV dev
    questions, documents of 512 tokens, NSF over percentile ranks, the
    rerank of the top 100: seconds per system, K1's launches, and the gate
    against targets from the run itself (passes) and far ones (exits 1)."""
    from fusion_tpu_torch.hybrid import HybridPipeline
    from fusion_tpu_torch.models.encoder import EncoderConfig
    from fusion_tpu_torch.tools import run_lleqa_parity as harness

    out: dict = {}
    systems = ("bm25", "dpr", "splade", "colbert", "fused", "reranked")
    tiny = os.path.join(root, "tiny")
    os.makedirs(tiny)
    fx = os.path.join(tiny, "lleqa.json")
    with open(fx, "w") as f:
        json.dump(LLEQA_TINY, f)
    paths = lleqa_checkpoints(tiny, EncoderConfig.tiny(vocab_size=512), 16, 32, 32, 16, "cpu")
    args = harness.parse_args(["--fixture", fx, *[a for n, p in paths.items() for a in (f"--{n}_path", p)]])
    data = harness.load_data(fx)
    runs, models = {}, {}
    for dev in ("cpu", "cuda"):
        reset_counts(*kernels)
        models[dev] = harness.load_models(args, torch.device(dev))
        runs[dev] = harness.evaluate_systems(data, "dev", models[dev], batch_size=8, device=dev)
        out[f"tiny_{dev}_K1"] = counts(*kernels)["K1"]
    check(out["tiny_cuda_K1"] > 0 and out["tiny_cpu_K1"] == 0, f"lleqa_parity tiny: K1 launches {out}")
    (cpu_rep, cpu_lists), (card_rep, card_lists) = runs["cpu"], runs["cuda"]
    legs = ("bm25", "dpr", "splade", "colbert")
    # the legs are held to the CPU's legs; the fusion and the rerank take the
    # legs' bf16-rounded scores (the percentile ranks move with them), so the
    # card's fusion is held to the CPU's fusion of the card's legs, and its
    # rerank to the CPU's rerank of the card's fused lists
    pipe = HybridPipeline(data.corpus, device="cpu")
    queries, labels = harness.split_queries(data, "dev")
    topk = min(1000, len(data.corpus))
    want = {s: (cpu_lists[s], cpu_rep["systems"][s]) for s in legs}
    fused = harness.fuse_systems(pipe, {s: on_host(card_lists[s]) for s in legs}, args.fusion, args.normalization,
                                 topk)
    reranked = pipe.cross_encoder_search(queries, on_host(card_lists["fused"]), models["cpu"]["monobert"],
                                         return_topk=min(args.rerank_depth, topk)).ranked
    for s, lists in (("fused", fused), ("reranked", reranked)):
        want[s] = (lists, harness.system_metrics(pipe, labels, lists))
    agree, ties, max_diff = {}, {}, {}
    for s in systems:
        tol = {"colbert": 2 * BF16_TIE, "fused": F32_TIE, "reranked": F32_TIE}.get(s, BF16_TIE)
        agree[s], ties[s] = lists_agree(np, card_lists[s], want[s][0], tol)
        w, g = want[s][1], card_rep["systems"][s]
        max_diff[s] = max(abs(g[m] - w[m]) for m in w if not isinstance(w[m], str))
        check(agree[s], f"lleqa_parity tiny: {s}'s card lists differ from the CPU's beyond ties within {tol}")
        if max_diff[s] > 1e-6:
            check(ties[s], f"lleqa_parity tiny: {s}'s metrics differ by {max_diff[s]} with no tie")
    out["tiny_systems_with_ties"] = [s for s in systems if ties[s]]
    out["tiny_lists_equal"] = {s: bool(agree[s] and not ties[s]) for s in systems}
    out["tiny_max_metric_diff"] = max_diff

    full = os.path.join(root, "full")
    os.makedirs(full)
    fx = os.path.join(full, "lleqa.json")
    t0 = time.perf_counter()
    with open(fx, "w") as f:
        json.dump(lleqa_fixture(np, LLEQA_ARTICLES, LLEQA_DEV, LLEQA_WORDS), f)
    cfg = EncoderConfig(dtype=torch.bfloat16, dropout=0.0)  # CamemBERT-base width
    paths = lleqa_checkpoints(full, cfg, 64, 512, 512, 128, "cuda")
    out["full_setup_s"] = time.perf_counter() - t0
    argv = ["--fixture", fx, *[a for n, p in paths.items() for a in (f"--{n}_path", p)], "--dtype", "bfloat16",
            "--out_dir", os.path.join(full, "out"), "--targets", os.path.join(full, "no_targets.json")]
    reset_counts(*kernels)
    t0 = time.perf_counter()
    report = harness.main(argv)
    torch.cuda.synchronize()
    out["full_s"] = time.perf_counter() - t0
    out["full_launches"] = counts(*kernels)
    out["full_seconds"] = report["seconds"]
    check(out["full_launches"]["K1"] > 0, "lleqa_parity full: K1 never launched")
    check(set(report["systems"]) == set(systems) and report["num_queries"] == LLEQA_DEV
          and report["corpus_size"] == LLEQA_ARTICLES, f"lleqa_parity full: report {list(report)}")
    for s in systems:
        values = [v for v in report["systems"][s].values() if not isinstance(v, str)]
        check(all(0.0 <= v <= 1.0 for v in values), f"lleqa_parity full: {s}'s metrics out of [0, 1]")
    out["full_recall@100"] = {s: report["systems"][s]["recall@100"] for s in systems}
    out["full_ndcg@10"] = {s: report["systems"][s]["ndcg@10"] for s in systems}
    self_targets = {s: {"recall@100": 100 * out["full_recall@100"][s], "ndcg@10": 100 * out["full_ndcg@10"][s]}
                    for s in systems}
    far_targets = {"bm25": {"recall@100": 100 * out["full_recall@100"]["bm25"] + 20.0}}
    for label, targets in (("self", self_targets), ("far", far_targets)):
        path = os.path.join(full, f"targets_{label}.json")
        with open(path, "w") as f:
            json.dump(targets, f)
        try:
            harness.apply_gate(report, path, 1.5)
            code = 0
        except SystemExit as e:
            code = e.code
        out[f"gate_{label}_exit"] = code
    check(out["gate_self_exit"] == 0 and out["gate_far_exit"] == 1, f"lleqa_parity full: gate exits {out}")
    gc.collect()
    torch.cuda.empty_cache()
    return out


def recall_check(torch, kernels) -> dict:
    """[recall_study]: tools/recall_study.py in process at RECALL_DOCS /
    RECALL_COLBERT_DOCS (widths as the tool's: H 768, V 32k, D 128), every
    launch count set to 0 just before and read just after: K1 (exhaustive
    compressed search), K2 (fused binned top-k), K3 (scatter), K4 (PLAID's
    gather) launch; every overlap in [0, 1]."""
    from fusion_tpu_torch.tools import recall_study

    args = recall_study.parse_args(["--n_docs", str(RECALL_DOCS), "--colbert_docs", str(RECALL_COLBERT_DOCS)])
    reset_counts(*kernels)
    detail = recall_study.run(args)["detail"]
    launches = counts(*kernels)
    for name in ("K1", "K2", "K3", "K4"):
        check(launches[name] > 0, f"recall_study: {name} never launched")
    overlaps = {k: v for k, v in detail.items() if "overlap" in k or "recall" in k or "frac" in k}
    bad = {k: v for k, v in overlaps.items() if isinstance(v, float) and not 0.0 <= v <= 1.0}
    check(not bad, f"recall_study: values out of [0, 1]: {bad}")
    check("int8_approx_topk" in detail["not_ported"], "recall_study: the approx row is not named as not ported")
    check(detail["dense_int8_exact_merge_overlap@100"] >= 0.9, f"recall_study: int8 exact merge {detail}")
    gc.collect()
    torch.cuda.empty_cache()
    return {"launches": launches, "section_seconds": detail["section_seconds"], "values": overlaps,
            "cheapest_plaid>=0.9": detail.get("plaid_cheapest_config_with_overlap>=0.9")}


def roofline_check(torch, np, docs, models, kernels) -> dict:
    """[roofline]: tools/probe_hybrid_roofline.py's sweep over the slice's
    corpus and encoders (a BM25 index at k1 2.5, b 0.2, impact cap 1,024;
    random bf16 dense, SPLADE and token corpora), B in ROOFLINE_BATCHES,
    plain and stacked: ms a batch, queries/s and MFU per row (one line each),
    K1's launches; the stacked fused ids equal the plain ones or overlap
    them >= 0.99 at 100."""
    from fusion_tpu_torch.tools import probe_hybrid_roofline as roof

    world, rng = roof.build_world(roof.parse_args([]), docs=docs, models=models)
    reset_counts(*kernels)
    rows = roof.sweep(world, rng, ROOFLINE_BATCHES, groups=ROOFLINE_GROUPS, per=ROOFLINE_PER,
                      emit=lambda line: print(f"[roofline_row] {line}", flush=True))
    launches = counts(*kernels)
    check(launches["K1"] > 0, "roofline: K1 never launched")
    for r in rows:
        if r["variant"] == "stacked":
            check(r["ids_equal_plain"] or r["overlap@100_vs_plain"] >= 0.99, f"roofline: stacked ids {r}")
    best = roof.best_record(rows, world.n_docs, world.topk)
    del world
    gc.collect()
    torch.cuda.empty_cache()
    return {"K1": launches["K1"], "best": {k: best["detail"]["best"][k] for k in ("variant", "batch",
                                                                                 "queries_per_s")},
            "rows": {f"{r['variant']}_B{r['batch']}": {
                "ms": r["ms_per_batch"], "queries_per_s": r["queries_per_s"], "mfu": r.get("mfu"),
                **({"ids_equal_plain": r["ids_equal_plain"]} if "ids_equal_plain" in r else {})} for r in rows}}


# [studies]: the cascade and int8-encoder studies' training steps and the
# preprocessor study's docs and queries (the tools' defaults, 600, 400 and
# 20,000 / 500, before the cut that made room for this slice's phases)
CASCADE_STEPS, INT8_ENCODER_STEPS, PREPROC_DOCS, PREPROC_QUERIES = 300, 200, 10_000, 250


def studies_check(torch, np) -> dict:
    """[studies]: the cascade (with its int8 view), int8-encoder and
    preprocessor studies on the card, at their default shapes but for the
    steps and sizes above; their headline numbers."""
    from fusion_tpu_torch.tools import cascade_study, int8_encoder_study, preprocessor_study

    out = {}
    t0 = time.perf_counter()
    rec = cascade_study.run(cascade_study.parse_args(["--int8", "--steps", str(CASCADE_STEPS)]))
    out["cascade"] = {"s": time.perf_counter() - t0, "final_bce": rec["setup"]["final_bce"],
                      "flat_mrr": rec["flat"]["all"]["mrr"], "int8_flat_mrr": rec["int8_flat"]["all"]["mrr"],
                      "int8_score_corr": rec["int8_flat"]["score_corr_vs_f32"],
                      "cascade_mrr_keep8": {c["stage1_tokens"]: c["metrics"]["all"]["mrr"]
                                            for c in rec["cascade_grid"] if c["keep"] == 8}}
    t0 = time.perf_counter()
    rec = int8_encoder_study.run(int8_encoder_study.parse_args(["--steps", str(INT8_ENCODER_STEPS)]))
    out["int8_encoder"] = {"s": time.perf_counter() - t0, "overlap": rec["value"], **rec["dense"],
                           "splade_corr": rec["splade_activation_corr"]}
    t0 = time.perf_counter()
    rec = preprocessor_study.measure(
        preprocessor_study.build_world(np.random.default_rng(42), PREPROC_DOCS, PREPROC_QUERIES), "cuda")
    out["preprocessor"] = {"s": time.perf_counter() - t0, "fallback_stemmer": rec["fallback_stemmer"],
                           "risk_bound_recall@10": rec["risk_bound_recall@10"],
                           "recall@10": {k: v["recall@10"] for k, v in rec["pipelines"].items()}}
    for name, vals in (("cascade", (out["cascade"]["flat_mrr"], out["cascade"]["int8_flat_mrr"])),
                       ("int8_encoder", (out["int8_encoder"]["overlap"], out["int8_encoder"]["mrr_f32"]))):
        check(all(0.0 <= v <= 1.0 for v in vals), f"studies: {name} {vals}")
    return out


# ----------------------------------------------------------------------
# training
# ----------------------------------------------------------------------
# family → (batch, query length, doc / pair length, negatives per query): the
# presets' shapes (DPR, SPLADE and monoBERT on LLeQA, ColBERT on mMARCO)
TRAIN_SHAPES = {"dpr": (64, 512, 512, 1), "splade": (32, 64, 512, 1), "colbert": (128, 32, 256, 1),
                "monobert": (32, 0, 256, 0)}
TRAIN_WARMUP, TRAIN_TIMED = 1, 3  # cut from 2 and 5 to keep the script inside its time limit
# [train_agreement], f32 card vs f32 CPU, gates per family on: the loss
# (relative), the largest gradient leaf apart (||card - cpu|| / ||cpu||),
# and the params after 3 steps, element by element in units of the lr or,
# for SPLADE, per leaf by the norm of the 3 steps' update.  SPLADE's max
# pooling routes a vocab entry's gradient to one token, and a near-tie
# between two tokens resolves either way from a last-digit difference: its
# gradient leaves differ by ~1e-3 between the two devices (1.35e-3 on an
# H100 80GB HBM3 at 700 W), and Adam turns rounding-level gradient elements
# into steps of +-lr (the CPU at 1 and at 8 threads already puts one
# decoder element 0.86 lr apart).  The other families read 6.4e-5 (DPR),
# 3.7e-6 (ColBERT) and 8.0e-7 (monoBERT) on gradients and at most 0.016 lr
# on params, and keep the narrow gates, which a card computing in TF32 or
# bf16 would not pass.
AGREE_LOSS_RTOL = 1e-4
AGREE_GATES = {
    "dpr": {"grad_max_rel": 1e-3, "param_max_abs_over_lr": 0.2},
    "splade": {"grad_max_rel": 1e-2, "update_max_rel": 5e-2},
    "colbert": {"grad_max_rel": 1e-3, "param_max_abs_over_lr": 0.2},
    "monobert": {"grad_max_rel": 1e-3, "param_max_abs_over_lr": 0.2},
}
# [train_parallel]'s X-MOD SPLADE and T5 cross-encoder runs take the gates of
# the families whose losses they share
AGREE_FAMILY = {"xmod_splade": "splade", "t5": "monobert"}
REMAT_GRAD_TOL = 2.0 ** -8  # [train_fit] remat on vs off, bf16: per leaf ||a - b|| / ||b||


def train_batch(np, family, b, lq, ld, n_neg, vocab, seed):
    """A batch of random ids at full length (every token real)."""
    rng = np.random.default_rng(seed)
    ids = lambda n, length: rng.integers(5, vocab, size=(n, length), dtype=np.int64)  # noqa: E731
    if family in ("monobert", "t5"):
        return {"pair_ids": ids(b, ld), "pair_mask": np.ones((b, ld), np.int32),
                "labels": (rng.random(b) < 0.5).astype(np.float32)}
    mask = lambda n, length: np.ones((n, length), np.float32 if family == "colbert" else np.int32)  # noqa: E731
    return {"query_ids": ids(b, lq), "query_mask": mask(b, lq), "pos_ids": ids(b, ld), "pos_mask": mask(b, ld),
            "neg_ids": ids(b * n_neg, ld), "neg_mask": mask(b * n_neg, ld)}


def train_model(torch, family, cfg, seed, device, params=None):
    """A family's model with f32 master weights: ``seed``'s, or ``params``
    (a state dict of them)."""
    from fusion_tpu_torch.models.biencoder import BiEncoder
    from fusion_tpu_torch.models.colbert import ColBERT
    from fusion_tpu_torch.models.crossencoder import CrossEncoder

    from fusion_tpu_torch.models.t5 import T5CrossEncoder

    kw = dict(seed=seed, params=params, device=device, param_dtype=torch.float32)
    if family in ("dpr", "splade"):
        return BiEncoder(cfg, head="dense" if family == "dpr" else "splade", **kw)
    if family == "xmod_splade":
        return BiEncoder(cfg, head="splade", **kw).set_language(XMOD_LANGUAGES[0])
    if family == "colbert":
        return ColBERT(cfg, dim=DIM, **kw)
    if family == "t5":
        return T5CrossEncoder(cfg, **kw)
    return CrossEncoder(cfg, **kw)


def train_loss(family, model, batch, step, seed=0, total_steps=30, mesh=None):
    """The family's training loss (DPR MNRL, SPLADE spladev2 on either
    trunk, ColBERT CE, the BCE of monoBERT and of T5) → (loss, metrics);
    with ``mesh``, over every data rank's rows."""
    from fusion_tpu_torch.models.biencoder import SPLADE_PRESETS
    from fusion_tpu_torch.train import trainer

    if family == "dpr":
        return trainer.biencoder_loss(model, batch, step, {"name": "MNRLoss", "scale": 20.0}, None, total_steps, seed,
                                      mesh)
    if family in ("splade", "xmod_splade"):
        v = SPLADE_PRESETS["spladev2"]
        return trainer.biencoder_loss(model, batch, step, v["rank_loss"], v["reg_loss"], total_steps, seed, mesh)
    if family == "colbert":
        return trainer.colbert_loss(model, batch, step, "ce", seed, mesh)
    return trainer.crossencoder_loss(model, batch, step, seed, mesh)


def train_step_fn(family, model, tx, total_steps=30, mesh=None):
    """The family's train step from its public factory, with
    ``train_loss``'s losses (data- and tensor-parallel with ``mesh``)."""
    from fusion_tpu_torch.models.biencoder import SPLADE_PRESETS
    from fusion_tpu_torch.train import trainer

    if family == "dpr":
        return trainer.make_biencoder_train_step(model, tx, {"name": "MNRLoss", "scale": 20.0}, None, total_steps,
                                                 mesh=mesh)
    if family in ("splade", "xmod_splade"):
        v = SPLADE_PRESETS["spladev2"]
        return trainer.make_biencoder_train_step(model, tx, v["rank_loss"], v["reg_loss"], total_steps, mesh=mesh)
    if family == "colbert":
        return trainer.make_colbert_train_step(model, tx, "ce", mesh=mesh)
    return trainer.make_crossencoder_train_step(model, tx, mesh=mesh)


def train_check(torch, np, device="cuda", attention_impl="einsum", warmup=TRAIN_WARMUP, timed=TRAIN_TIMED,
                traced=True) -> dict:
    """[train]: each family at its preset's shapes, CamemBERT-base width,
    bf16 compute over f32 master weights, remat on, AdamW, attention in the
    form ``attention_impl``: ``warmup`` (1) warm-up and ``timed`` (3) timed
    steps, each ended by a synchronize, then (with ``traced``) one traced
    step (device time, busy share, the top device operations)."""
    from fusion_tpu_torch.models.encoder import EncoderConfig
    from fusion_tpu_torch.train import trainer
    from fusion_tpu_torch.utils import profiling

    cfg = EncoderConfig(dtype=torch.bfloat16, remat=True, attention_impl=attention_impl)
    out = {}
    for seed, (family, (b, lq, ld, n_neg)) in enumerate(TRAIN_SHAPES.items()):
        t0 = time.perf_counter()
        model = train_model(torch, family, cfg, 100 + seed, device)
        batch = trainer._to_device(train_batch(np, family, b, lq, ld, n_neg, cfg.vocab_size, seed), model.device)
        fit_cfg = trainer.FitConfig(steps=30, learning_rate=2e-5)
        state, tx, _ = trainer.init_train_state(model, fit_cfg)
        step = train_step_fn(family, model, tx)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        times, losses = [], []
        for i in range(warmup + timed):
            w0 = time.perf_counter()
            state, metrics = step(state, batch)
            torch.cuda.synchronize()
            if i >= warmup:
                times.append((time.perf_counter() - w0) * 1000)
            losses.append(metrics["loss"].item())
            check(np.isfinite(losses[-1]), f"train {family}: step {i} loss {losses[-1]}")
        ms = statistics.median(times)
        # the last step; its state is not kept
        profiled = stage_profile(torch, lambda: step(state, batch)) if traced else None
        n_seq = b if family == "monobert" else b * (2 + n_neg)
        n_tok = b * ld if family == "monobert" else b * lq + b * (1 + n_neg) * ld
        model_flops, hw_flops = profiling.train_step_flops(cfg, family, b, lq, ld, n_neg, DIM)
        out[family] = {
            "shape": f"B{b}xLq{lq}xLd{ld}xneg{n_neg}", "ms_per_step": ms, "ms_all": times,
            "sequences_per_s": n_seq / ms * 1000, "tokens_per_s": n_tok / ms * 1000,
            "peak_gb": torch.cuda.max_memory_allocated() / 2**30,
            "model_tflop_per_step": model_flops / 1e12, "hw_tflop_per_step": hw_flops / 1e12,
            "mfu": profiling.utilization(model_flops, ms / 1000), "hw_util": profiling.utilization(hw_flops, ms / 1000),
            "losses": losses, "traced_step": profiled, "wall_s": time.perf_counter() - t0,
        }
        del model, state, tx, step, batch
        gc.collect()
        torch.cuda.empty_cache()
    return out


def _grads(model) -> dict:
    return {n: p.grad.detach().float().cpu() for n, p in model.module.named_parameters()}


def _max_rel(a: dict, b: dict) -> float:
    return max(float((a[k] - b[k]).norm() / max(float(b[k].norm()), 1e-30)) for k in b)


def train_agreement(torch, np, device="cuda", attention_impl="einsum") -> dict:
    """[train_agreement]: the f32 train step on the card against the CPU,
    CamemBERT-base width at 2 layers, batch 4 (query 32, doc 64), dropout 0,
    attention in the form ``attention_impl``: the loss and every gradient at
    step 4, then the update of 3 AdamW steps (lr 1e-3, linear warmup over 3
    of 10 steps), each held to its family's ``AGREE_GATES``.  In the flash
    form the card runs FA and FA-bwd on their f32 path (their launches
    counted, both > 0) and the CPU their plain versions."""
    from fusion_tpu_torch.models.encoder import EncoderConfig
    from fusion_tpu_torch.ops.attention import masked_attention_backward_cuda, masked_attention_cuda
    from fusion_tpu_torch.train import trainer

    cfg = EncoderConfig(num_layers=2, dropout=0.0, attention_impl=attention_impl)
    masked_attention_cuda.launches = masked_attention_backward_cuda.launches = 0
    out = {}
    for seed, family in enumerate(TRAIN_SHAPES):
        host = train_batch(np, family, 4, 32, 64, 1, cfg.vocab_size, 50 + seed)
        res = {}
        for dev in ("cpu", device):
            model = train_model(torch, family, cfg, 200 + seed, dev)
            batch = trainer._to_device(host, model.device)
            loss, _ = train_loss(family, model, batch, 4)
            loss.backward()
            grads = _grads(model)
            before = {k: v.detach().cpu().clone() for k, v in model.module.state_dict().items()}
            fit_cfg = trainer.FitConfig(steps=10, learning_rate=1e-3, warmup_ratio=0.3)
            state, tx, _ = trainer.init_train_state(model, fit_cfg)
            step = train_step_fn(family, model, tx, total_steps=10)
            for _ in range(3):
                state, _ = step(state, batch)
            after = {k: v.detach().cpu() for k, v in model.module.state_dict().items()}
            res[dev] = (loss.item(), grads, {k: after[k] - before[k] for k in after}, after)
            del model, state, tx, step
        (l_cpu, g_cpu, u_cpu, p_cpu), (l_gpu, g_gpu, u_gpu, p_gpu) = res["cpu"], res[device]
        out[family] = {
            "loss_rel": abs(l_gpu - l_cpu) / abs(l_cpu),
            "grad_max_rel": _max_rel(g_gpu, g_cpu),
            "update_max_rel": _max_rel(u_gpu, u_cpu),
            "param_max_abs_over_lr": max(float((p_gpu[k] - p_cpu[k]).abs().max()) for k in p_cpu) / 1e-3,
        }
        r = out[family]
        check(r["loss_rel"] <= AGREE_LOSS_RTOL and all(r[k] <= lim for k, lim in AGREE_GATES[family].items()),
              f"train_agreement {attention_impl} {family}: {r} against {AGREE_GATES[family]}")
    out["launches"] = {"FA": masked_attention_cuda.launches, "FA-bwd": masked_attention_backward_cuda.launches}
    check((min(out["launches"].values()) > 0) == (attention_impl == "flash"),
          f"train_agreement {attention_impl}: attention kernel launches {out['launches']}")
    gc.collect()
    torch.cuda.empty_cache()
    return out


def train_fit(torch, np, device="cuda") -> dict:
    """[train_fit]: full width, bf16, remat, dropout 0.1, one repeated batch
    of 8 (query 32, doc 128) at a constant lr 1e-4: the loss after 20 AdamW
    steps below the first step's; then the first step's loss and gradients
    with remat on and off (the recompute draws the first forward's masks)."""
    from fusion_tpu_torch.models.encoder import EncoderConfig
    from fusion_tpu_torch.train import trainer

    out = {}
    for seed, family in enumerate(TRAIN_SHAPES):
        host = train_batch(np, family, 8, 32, 128, 1, 32_005, 70 + seed)
        cfg = EncoderConfig(dtype=torch.bfloat16, remat=True)
        model = train_model(torch, family, cfg, 300 + seed, device)
        # the seed's weights, drawn once: the remat pair below starts from them
        initial = {k: v.detach().to("cpu", copy=True) for k, v in model.module.state_dict().items()}
        batch = trainer._to_device(host, model.device)
        fit_cfg = trainer.FitConfig(steps=21, learning_rate=1e-4, scheduler="constant")
        state, tx, _ = trainer.init_train_state(model, fit_cfg)
        step = train_step_fn(family, model, tx, total_steps=21)
        losses = []
        for _ in range(21):
            state, metrics = step(state, batch)
            losses.append(metrics["loss"].item())
        del model, state, tx, step
        grads, first = [], []
        for remat in (True, False):
            m = train_model(torch, family, dataclasses.replace(cfg, remat=remat), 300 + seed, device, initial)
            loss, _ = train_loss(family, m, batch, 0, seed=9)
            loss.backward()
            grads.append(_grads(m))
            first.append(loss.item())
            del m
        out[family] = {"loss_step1": losses[0], "loss_after_20": losses[20], "remat_loss": first,
                       "remat_grad_max_rel": _max_rel(grads[0], grads[1])}
        r = out[family]
        check(all(np.isfinite(losses)) and losses[20] < losses[0], f"train_fit {family}: losses {losses}")
        check(first[0] == first[1] and r["remat_grad_max_rel"] <= REMAT_GRAD_TOL, f"train_fit {family} remat: {r}")
        gc.collect()
        torch.cuda.empty_cache()
    return out


# ----------------------------------------------------------------------
# training through flash: FA-bwd, the ColBERT bench step, HF imports
# ----------------------------------------------------------------------
# [attention_bwd] dq, dk, dv against the plain backward: atol, rtol.  bf16:
# both round P and dS to bf16 as product operands, in another summation
# order (the kernel's wmma tiles against the CPU-style einsum), so a value
# can land one bf16 ulp (2^-8 relative) apart; f32: f32 sums in another order
ATTN_BWD_TOL = {"bf16": (3e-2, 1e-2), "f32": (1e-5, 1e-5)}
BENCH_DOC_SHAPE = (1024, 256, 12, 64)  # one layer's doc call of the ColBERT bench step
FLASH_TRAIN_STEPS = 3


def attention_bwd_work(torch, q, mask, seg) -> tuple[float, float]:
    """(operations, bytes) of the attention backward on these operands: five
    products (S, dP, dV, dK, dQ) of 2 hd operations per head for each
    (query, allowed key) pair, a query with no allowed key counting every
    key of its row; q, k, v, out, dO read and dq, dk, dv written once, the
    f32 residuals m, l and the int32 masks read once."""
    from fusion_tpu_torch.ops.attention import allowed_keys

    b, length, heads, hd = q.shape
    n = allowed_keys(mask, seg).expand(b, 1, length, length).sum(-1)
    pairs = torch.where(n > 0, n, length).sum().item()
    masks = 1 if seg is None else 2
    return (10.0 * hd * heads * pairs,
            8.0 * q.numel() * q.element_size() + 8.0 * b * heads * length + 4.0 * masks * b * length)


def attention_bwd_check(torch, runs, device="cuda") -> dict:
    """[attention_bwd]: FA's residual mode and FA-bwd (``csrc/attention.cu``)
    against their plain versions: one layer's doc call of the ColBERT bench
    step ([1024, 256, 12, 64] bf16, every token real), the packed rerank
    shape ([128, 256, 12, 64] bf16 with segments), a ragged L 37 with an
    all-pad row in bf16 and f32, and packed rows in f32 ([16, 256, 12, 64]):
    the residual mode's output bit-equal to the inference call's, its m
    within 1e-5 and l within 1e-5 relative of the plain log-sum-exp parts;
    dq, dk, dv within ATTN_BWD_TOL and bit-identical over REPEATS more
    launches; also DPR's length, L 512 bf16 with ragged rows ([32, 512, 12,
    64]: eight tiles of each kind), and a rank's calls in [train_parallel]'s
    ColBERT step under model = 2 (6 heads of the fused [B, L, 3, 6, 64]
    projection: negatives [96, 256], ragged queries [32, 32]).  In every
    case the output within ATTN_TOL of the plain version's.  At the bench shape: FA inference
    against residual mode, and the D pass (``rowdot_cuda``) alone against
    the torch reduction it replaced, in CUDA-event turns.  At the bench and
    the packed shapes: FA-bwd against its plain version in CUDA-event
    turns, its device time from queued calls and by kernel in a
    torch.profiler trace, the library
    backward (scaled_dot_product_attention's, memory-efficient backend, the
    same boolean mask) and the bound."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from fusion_tpu_torch.ops.attention import (
        allowed_keys,
        masked_attention_backward_cuda,
        masked_attention_backward_plain,
        masked_attention_cuda,
        masked_attention_plain,
        rowdot_cuda,
    )
    from fusion_tpu_torch.tools import bench_maxsim
    from fusion_tpu_torch.tools.attention_ab import packed_rows

    gen = torch.Generator(device=device).manual_seed(43)
    b, length, heads, hd = BENCH_DOC_SHAPE
    ragged_mask = (torch.arange(37, device=device)[None] < torch.tensor([[37], [20], [0]], device=device)).int()
    ragged_seg = torch.where(torch.arange(37, device=device) < 15, 1, 2)[None].expand(3, 37) * ragged_mask
    cases = {
        "bench_doc": (BENCH_DOC_SHAPE, torch.bfloat16, torch.ones((b, length), dtype=torch.int32, device=device),
                      None),
        "packed": ((128, 256, heads, hd), torch.bfloat16, *packed_rows(128, 256, 5, device)),
        "ragged_bf16": ((3, 37, 2, hd), torch.bfloat16, ragged_mask, ragged_seg),
        "ragged_f32": ((3, 37, 2, hd), torch.float32, ragged_mask, ragged_seg),
        "packed_f32": ((16, 256, heads, hd), torch.float32, *packed_rows(16, 256, 6, device)),
        "dpr512": ((32, 512, heads, hd), torch.bfloat16,
                   (torch.arange(512, device=device)[None]
                    < torch.randint(1, 513, (32, 1), generator=gen, device=device)).int(), None),
        # a rank's negatives and queries in [train_parallel]'s ColBERT step
        # under model = 2: 6 of the 12 heads of the fused projection
        "model2_neg": ((96, 256, heads // 2, hd), torch.bfloat16,
                       torch.ones((96, 256), dtype=torch.int32, device=device), None),
        "model2_query": ((32, 32, heads // 2, hd), torch.bfloat16,
                         (torch.arange(32, device=device)[None]
                          < torch.randint(1, 33, (32, 1), generator=gen, device=device)).int(), None),
    }
    out, err_max = {}, 0.0
    for name, ((nb, nl, nh, nd), dtype, mask, seg) in cases.items():
        qkv = torch.randn((nb, nl, 3, nh, nd), generator=gen, device=device).to(dtype)
        d_out = torch.randn((nb, nl, nh, nd), generator=gen, device=device).to(dtype)
        q, k, v = qkv.unbind(2)
        atol, rtol = ATTN_BWD_TOL["bf16" if dtype == torch.bfloat16 else "f32"]
        with torch.no_grad():
            o, m, l = masked_attention_cuda(q, k, v, mask, seg, 0.125, residuals=True)
            check(torch.equal(o, masked_attention_cuda(q, k, v, mask, seg, 0.125)),
                  f"attention_bwd {name}: the residual mode's output differs from the inference call's")
            po, pm, pl = masked_attention_plain(q, k, v, mask, seg, 0.125, residuals=True)
            o_atol, o_rtol = ATTN_TOL["bf16" if dtype == torch.bfloat16 else "f32"]
            o_err = (o.float() - po.float()).abs()
            check(bool((o_err <= o_atol + o_rtol * po.float().abs()).all()),
                  f"attention_bwd {name}: the output off its plain version by {o_err.max().item()}")
            m_err = ((m - pm).abs() / (1 + pm.abs())).max().item()
            l_err = ((l - pl).abs() / pl).max().item()
            check(m_err <= 1e-5 and l_err <= 1e-5, f"attention_bwd {name}: residuals off by {m_err}, {l_err}")
            del po, pm, pl
            bwd = lambda: masked_attention_backward_cuda(q, k, v, o, m, l, d_out, mask, seg, 0.125)  # noqa: E731
            plain = lambda: masked_attention_backward_plain(q, k, v, o, m, l, d_out, mask, seg, 0.125)  # noqa: E731
            got, want = bwd(), plain()
            res = {"shape": [nb, nl, nh, nd], "dtype": str(dtype), "segments": seg is not None,
                   "o_max_abs_err": o_err.max().item(), "residual_m_rel_err": m_err, "residual_l_rel_err": l_err,
                   "tol": [atol, rtol]}
            for gname, g, w in zip(("dq", "dk", "dv"), got, want):
                err = (g.float() - w.float()).abs()
                res[f"{gname}_max_abs_err"] = err.max().item()
                check(bool((err <= atol + rtol * w.float().abs()).all()),
                      f"attention_bwd {name}: {gname} off its plain version by {res[f'{gname}_max_abs_err']}")
            del want
            res["max_abs_err"] = max(res[f"{g}_max_abs_err"] for g in ("dq", "dk", "dv"))
            check(all(all(torch.equal(a, c) for a, c in zip(got, bwd())) for _ in range(REPEATS)),
                  f"attention_bwd {name}: repeated launches differ")
            res["bit_identical_launches"] = REPEATS + 1
            if dtype == torch.bfloat16:
                err_max = max(err_max, res["max_abs_err"])
            if name == "bench_doc":
                res["fa_ms"], res["fa_residual_ms"] = alternating_ms(
                    torch, lambda: masked_attention_cuda(q, k, v, mask, seg, 0.125),
                    lambda: masked_attention_cuda(q, k, v, mask, seg, 0.125, residuals=True), runs)
                # the D pass against the f32 reduction: f32 sums of the same
                # 64 exact products in another order
                d_want = (d_out.float() * o.float()).sum(-1).transpose(1, 2)
                res["rowdot_rel_err"] = ((rowdot_cuda(d_out, o) - d_want).abs() / (1 + d_want.abs())).max().item()
                check(res["rowdot_rel_err"] <= 1e-5, f"attention_bwd: the D pass off by {res['rowdot_rel_err']}")
                del d_want
                res["rowdot_ms"], res["torch_rowdot_ms"] = alternating_ms(
                    torch, lambda: rowdot_cuda(d_out, o),
                    lambda: (d_out.float() * o.float()).sum(-1).transpose(1, 2).contiguous(), runs)
                res["rowdot_device_ms"] = queued_ms(torch, lambda: rowdot_cuda(d_out, o), runs)[0]
            if name in ("bench_doc", "packed"):
                res["ms"], res["plain_ms"] = alternating_ms(torch, bwd, plain, runs)
                flops, nbytes = attention_bwd_work(torch, q, mask, seg)
                res["bound_ms"], res["bound_by"] = bench_maxsim.bound(flops, nbytes)
                res["tflops_per_s"] = flops / res["ms"] / 1e9
                res["gb_moved"] = nbytes / 1e9
                res["share_of_bound"] = res["bound_ms"] / res["ms"]
                res["device_ms"], res["queue_full"] = queued_ms(torch, bwd, runs)
                res["device_share_of_bound"] = res["bound_ms"] / res["device_ms"]
                res["traced"] = attention_device_ms(torch, bwd)
        if name in ("bench_doc", "packed"):
            qt, kt, vt = (t.detach().transpose(1, 2).requires_grad_() for t in (q, k, v))
            with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
                o_lib = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=allowed_keys(mask, seg), scale=0.125)
                g_lib = d_out.transpose(1, 2)
                lib = lambda: torch.autograd.grad(o_lib, (qt, kt, vt), g_lib, retain_graph=True)  # noqa: E731
                lib()
                res["library_ms"] = statistics.median(timed_ms(torch, lib, runs))
                res["library_device_ms"] = queued_ms(torch, lib, runs)[0]
            del o_lib, qt, kt, vt
        out[name] = res
        del qkv, d_out, got, o, m, l
        gc.collect()
        torch.cuda.empty_cache()
    out["max_abs_err"] = err_max
    return out


def train_flash_check(torch, np, device="cuda") -> dict:
    """[train_flash]: ``tools/bench_colbert_train.py``'s step at full width
    (batch 128, 8-way, query 32, doc 256, CamemBERT-base, dropout 0, bf16
    over f32 masters, remat, AdamW 5e-6) in the flash form and in
    einsum_bf16 (the form JAX trains with): one warm-up step,
    FLASH_TRAIN_STEPS timed ones and a traced one each (ms/step, useful and
    hardware MFU, peak memory, the top device operations), every loss
    finite.  The flash run is this slice's main path: FA's and FA-bwd's
    counts are set to 0 just before it and read just after; per step FA
    must launch 72 times (36 layer forwards, 36 remat recomputes) and FA-bwd
    36."""
    from fusion_tpu_torch.ops.attention import masked_attention_backward_cuda, masked_attention_cuda
    from fusion_tpu_torch.tools import bench_colbert_train

    out = {}
    for form in ("flash", "einsum_bf16"):
        args = bench_colbert_train.parse_args(["--attention", form, "--steps", str(FLASH_TRAIN_STEPS),
                                               "--device", device])
        masked_attention_cuda.launches = masked_attention_backward_cuda.launches = 0
        record = bench_colbert_train.run(args, trace=True)
        launches = {"FA": masked_attention_cuda.launches, "FA-bwd": masked_attention_backward_cuda.launches}
        print(json.dumps(record), flush=True)
        d = record["detail"]
        out[form] = {"ms_per_step": record["value"], "examples_per_s": d["examples_per_s"],
                     "useful_mfu": d["useful_mfu"], "mfu_hw": d["mfu_hw"], "peak_mem_gib": d["peak_mem_gib"],
                     "launches": launches, "fa_per_step": d["fa_launches_per_step"],
                     "fa_bwd_per_step": d["fa_bwd_launches_per_step"], "traced_step": d["traced_step"]}
        steps = FLASH_TRAIN_STEPS + 1 + (d["traced_step"] is not None)  # warm-up, timed, traced
        if form == "flash":
            check(d["fa_launches_per_step"] == 72 and d["fa_bwd_launches_per_step"] == 36
                  and launches["FA"] == 72 * steps and launches["FA-bwd"] == 36 * steps,
                  f"train_flash: FA / FA-bwd launched {launches}, per step {d['fa_launches_per_step']} / "
                  f"{d['fa_bwd_launches_per_step']} (want 72 / 36 per step)")
        else:
            check(launches == {"FA": 0, "FA-bwd": 0}, f"train_flash einsum_bf16 launched the kernels: {launches}")
        gc.collect()
        torch.cuda.empty_cache()
    out["flash_over_einsum_bf16"] = out["flash"]["ms_per_step"] / out["einsum_bf16"]["ms_per_step"]
    return out


def hf_roberta_state(torch, hf: dict, seed: int, prefix: str = "roberta.", languages=()) -> dict:
    """Seeded HF-named weights of a RoBERTa-family masked LM (``prefix``
    trunk + ``lm_head``) or, with ``languages``, an X-MOD trunk with those
    adapters: normal(0, 0.02) matrices, unit LayerNorm weights, small
    biases."""
    gen = torch.Generator().manual_seed(seed)
    h, inter, v = hf["hidden_size"], hf["intermediate_size"], hf["vocab_size"]

    def w(*shape):
        return torch.randn(shape, generator=gen) * 0.02

    out = {f"{prefix}embeddings.word_embeddings.weight": w(v, h),
           f"{prefix}embeddings.position_embeddings.weight": w(hf["max_position_embeddings"], h),
           f"{prefix}embeddings.token_type_embeddings.weight": w(hf["type_vocab_size"], h)}

    def ln(name):
        out[f"{name}.weight"], out[f"{name}.bias"] = 1 + w(h), w(h)

    ln(f"{prefix}embeddings.LayerNorm")
    for i in range(hf["num_hidden_layers"]):
        lp = f"{prefix}encoder.layer.{i}"
        for n in ("query", "key", "value"):
            out[f"{lp}.attention.self.{n}.weight"], out[f"{lp}.attention.self.{n}.bias"] = w(h, h), w(h)
        out[f"{lp}.attention.output.dense.weight"], out[f"{lp}.attention.output.dense.bias"] = w(h, h), w(h)
        ln(f"{lp}.attention.output.LayerNorm")
        out[f"{lp}.intermediate.dense.weight"], out[f"{lp}.intermediate.dense.bias"] = w(inter, h), w(inter)
        out[f"{lp}.output.dense.weight"], out[f"{lp}.output.dense.bias"] = w(h, inter), w(h)
        ln(f"{lp}.output.LayerNorm")
        for lang in languages:
            ap = f"{lp}.output.adapter_modules.{lang}"
            b = h // hf["adapter_reduction_factor"]
            out[f"{ap}.dense1.weight"], out[f"{ap}.dense1.bias"] = w(b, h), w(b)
            out[f"{ap}.dense2.weight"], out[f"{ap}.dense2.bias"] = w(h, b), w(h)
    if not languages:
        out["lm_head.dense.weight"], out["lm_head.dense.bias"] = w(h, h), w(h)
        ln("lm_head.layer_norm")
        out["lm_head.bias"] = w(v)
    return out


def hf_train_check(torch, np, root, device="cuda", layers=12, batch=16) -> dict:
    """[hf_train]: HF checkpoint directories written here without
    ``transformers`` at CamemBERT-base width (12 layers, vocab 32,005,
    seeded random weights under HF's names): a CamemBERT masked LM as
    ``model.safetensors`` and an X-MOD trunk with two language adapters
    (fr_XX, de_DE; the same vocabulary) as ``pytorch_model.bin``.  Each
    loads through ``ColBERT.from_pretrained_hf`` / ``ColBERT.from_xmod``
    (bf16 over f32 masters; the word embeddings bit-equal to the written
    ones), takes ``with_attention("flash")`` and trains 3 AdamW steps on a
    random batch of 16 (8-way, query 32, doc 128): every loss finite, FA and
    FA-bwd launched (counts set to 0 just before, read just after: 3 steps x
    3 forwards x 12 layers each, no remat)."""
    from fusion_tpu_torch.models.colbert import ColBERT
    from fusion_tpu_torch.ops.attention import masked_attention_backward_cuda, masked_attention_cuda
    from fusion_tpu_torch.train import trainer
    from fusion_tpu_torch.utils import hf_weights

    base = {"vocab_size": 32_005, "hidden_size": 768, "num_hidden_layers": layers, "num_attention_heads": 12,
            "intermediate_size": 3072, "max_position_embeddings": 514, "type_vocab_size": 1, "pad_token_id": 1,
            "bos_token_id": 0, "eos_token_id": 2, "layer_norm_eps": 1e-5, "hidden_act": "gelu"}
    dirs = {
        "camembert": ({**base, "model_type": "camembert", "architectures": ["CamembertForMaskedLM"]},
                      "model.safetensors", ()),
        "xmod": ({**base, "model_type": "xmod", "architectures": ["XmodModel"], "languages": ["fr_XX", "de_DE"],
                  "adapter_reduction_factor": 2, "ln_before_adapter": True, "adapter_reuse_layer_norm": True,
                  "adapter_layer_norm": False, "pre_norm": False}, "pytorch_model.bin", ("fr_XX", "de_DE")),
    }
    host = train_batch(np, "colbert", batch, 32, 128, 7, base["vocab_size"], 90)
    want = 3 * 3 * layers  # 3 steps x 3 forwards, one launch a layer
    out = {}
    for seed, (name, (hf, weights, languages)) in enumerate(dirs.items()):
        t0 = time.perf_counter()
        path = os.path.join(root, name)
        os.makedirs(path)
        with open(os.path.join(path, "config.json"), "w") as f:
            json.dump(hf, f)
        state = hf_roberta_state(torch, hf, 80 + seed, prefix="" if languages else "roberta.", languages=languages)
        if weights.endswith(".safetensors"):
            hf_weights.write_safetensors(state, os.path.join(path, weights))
        else:
            torch.save(state, os.path.join(path, weights))
        write_s = time.perf_counter() - t0
        kw = dict(dim=DIM, device=device, dtype=torch.bfloat16, param_dtype=torch.float32)
        model = (ColBERT.from_xmod(path, lang="de", **kw) if languages else ColBERT.from_pretrained_hf(path, **kw))
        word = state[("" if languages else "roberta.") + "embeddings.word_embeddings.weight"]
        check(torch.equal(model.module.encoder.embeddings.word.weight.cpu(), word),
              f"hf_train {name}: the loaded word embeddings differ from the written ones")
        check(model.cfg.dropout == 0.0 and not model.cfg.remat, f"hf_train {name}: {model.cfg}")
        model = model.with_attention("flash")
        batch = trainer._to_device(host, model.device)
        state_t, tx, _ = trainer.init_train_state(model, trainer.FitConfig(steps=3, learning_rate=5e-6,
                                                                           scheduler="constant"))
        step = trainer.make_colbert_train_step(model, tx, "ce")
        masked_attention_cuda.launches = masked_attention_backward_cuda.launches = 0
        losses = []
        for _ in range(3):
            state_t, metrics = step(state_t, batch)
            losses.append(float(metrics["loss"]))
        launches = {"FA": masked_attention_cuda.launches, "FA-bwd": masked_attention_backward_cuda.launches}
        check(all(np.isfinite(losses)), f"hf_train {name}: losses {losses}")
        check(launches == {"FA": want, "FA-bwd": want}, f"hf_train {name}: launches {launches} (want {want} each)")
        out[name] = {"weights": weights, "write_s": write_s, "load_and_train_s": time.perf_counter() - t0 - write_s,
                     "losses": losses, "launches": launches,
                     "languages": list(getattr(model.cfg, "languages", ()))}
        del model, state_t, tx, step, batch, state
        gc.collect()
        torch.cuda.empty_cache()
    return out


def cli_train_check(torch, np, root, kernels, device="cuda") -> dict:
    """[cli_train]: the CLI's dpr / splade / colbert / monobert (and
    monobert --backbone t5) in process at --tiny on a fixture it writes
    (300 docs of the zipf words spelled in letters, 48 train and 16 dev
    questions, BM25-style negatives): --task train (10 steps, batch 8), then
    --task test on the saved final/; the ColBERT test task searches through
    K1 (its launches counted); each final/ reloaded by the port encodes as
    the trained model does."""
    from fusion_tpu_torch.cli.main import main as cli_main
    from fusion_tpu_torch.models.biencoder import BiEncoder
    from fusion_tpu_torch.models.colbert import ColBERT
    from fusion_tpu_torch.models.crossencoder import CrossEncoder
    from fusion_tpu_torch.models.encoder import token_tensors
    from fusion_tpu_torch.models.t5 import T5CrossEncoder

    docs, queries = zipf_corpus(np, 300, 64, seed=5, vocab=2_000)
    docs, queries = [letter_text(d) for d in docs], [letter_text(q) for q in queries]
    rng = np.random.default_rng(6)
    gold = rng.integers(0, len(docs), size=len(queries))
    question = lambda qi: {"id": qi, "question": queries[qi], "article_ids": [1000 + int(gold[qi])]}  # noqa: E731
    fixture = {
        "corpus": [{"id": 1000 + i, "article": d, "description": ""} for i, d in enumerate(docs)],
        "questions": {"train": [question(q) for q in range(48)], "dev": [question(q) for q in range(48, 64)],
                      "test": []},
        "negatives": {str(q): {"bm25": [1000 + int(x) for x in rng.integers(0, len(docs), 3)]} for q in range(48)},
    }
    fx = os.path.join(root, "train_fixture.json")
    with open(fx, "w") as f:
        json.dump(fixture, f)
    out = {}
    runs = {"dpr": ("dpr", [], BiEncoder), "splade": ("splade", [], BiEncoder), "colbert": ("colbert", [], ColBERT),
            "monobert": ("monobert", [], CrossEncoder),
            "monobert_t5": ("monobert", ["--backbone", "t5"], T5CrossEncoder)}
    for label, (cmd, extra, cls) in runs.items():
        out_dir = os.path.join(root, f"train_{label}")
        base = ["--fixture", fx, "--output_dir", out_dir, "--tiny", "--device", device] + extra
        t0 = time.perf_counter()
        model = cli_main([cmd, "--task", "train", "--steps", "10", "--train_batch_size", "8"] + base)
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        final = os.path.join(out_dir, "final")
        reset_counts(*kernels)
        t0 = time.perf_counter()
        cli_main([cmd, "--task", "test", "--model_path", final] + base)
        torch.cuda.synchronize()
        rec = {"train_s": train_s, "test_s": time.perf_counter() - t0, "K1": counts(*kernels)["K1"]}
        loaded = cls.load(final, device=device)
        if cmd == "monobert":
            pairs = [(q, docs[i]) for i, q in enumerate(queries[:16])]
            same = np.array_equal(loaded.predict(pairs), model.predict(pairs))
        else:
            ids, mask = model.text_encoder.encode(queries[:16], query_mode=True)
            t = token_tensors(ids, mask, device)
            same = bool(torch.equal(loaded.embed_tokens(*t), model.embed_tokens(*t)))
        rec["reload_equal"] = same
        check(same, f"cli_train {label}: the reloaded final/ encodes otherwise than the trained model")
        metrics_file = {"colbert": "performance_colbert.json", "monobert": "rerank_eval_results.csv"}.get(
            cmd, "ir_eval_results.csv")
        check(os.path.isfile(os.path.join(out_dir, metrics_file)), f"cli_train {label}: no {metrics_file}")
        out[label] = rec
        del model, loaded
    check(out["colbert"]["K1"] > 0, "cli_train: colbert --task test never launched K1")
    gc.collect()
    torch.cuda.empty_cache()
    return out


# [sharded]: ranks on the one card, and the time the two-rank part may take
# (the children's load, searches and checks take about half a minute on an
# H100; a rank that dies leaves the other waiting in a collective)
SHARDED_RANKS, SHARDED_TIMEOUT = 2, 420


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def same_up_to_ties(np, got_ids, got_scores, want_ids, want_scores, atol) -> bool:
    """Scores within ``atol`` (the same -inf pattern) and ids equal position
    by position, except inside runs of reference scores within ``atol`` of
    each other, which must hold the same ids as sets (a run that reaches the
    last position is held to its scores only: its members past the cut are
    in neither list)."""
    gi, wi, g, w = (np.asarray(x) for x in (got_ids, want_ids, got_scores, want_scores))
    fin = np.isfinite(w)
    if gi.shape != wi.shape or not (np.isfinite(g) == fin).all():
        return False
    if not np.allclose(np.where(fin, g, 0.0), np.where(fin, w, 0.0), atol=atol, rtol=0.0):
        return False
    for row in range(w.shape[0]):
        s, start = w[row], 0
        for end in range(1, len(s) + 1):
            if end == len(s) or not (s[end] == s[end - 1] or abs(s[end] - s[end - 1]) <= atol):
                if end < len(s) and set(gi[row, start:end].tolist()) != set(wi[row, start:end].tolist()):
                    return False
                start = end
    return True


class plain_kernels:
    """Within the block, K2, K3, K4 and FA's dispatchers send tensors on the
    card to the kernels' plain versions (the same tensors, PyTorch ops)."""

    def __enter__(self):
        from fusion_tpu_torch.index import plaid
        from fusion_tpu_torch.models import encoder
        from fusion_tpu_torch.ops import attention, dense_topk, gather_rows, scatter_score

        self.saved = (dense_topk.binmax, scatter_score.scatter_binmax, plaid.gather_rows, encoder.masked_attention)
        dense_topk.binmax = lambda q, v, s, n, doc_block=2048, dead_rows=True: dense_topk.binmax_plain(
            q, v, s, n, doc_block, dead_rows=dead_rows)
        scatter_score.scatter_binmax = scatter_score.scatter_binmax_plain
        plaid.gather_rows = gather_rows.gather_rows_plain
        encoder.masked_attention = attention.masked_attention_plain
        return self

    def __exit__(self, *exc):
        from fusion_tpu_torch.index import plaid
        from fusion_tpu_torch.models import encoder
        from fusion_tpu_torch.ops import dense_topk, scatter_score

        dense_topk.binmax, scatter_score.scatter_binmax, plaid.gather_rows, encoder.masked_attention = self.saved


def sharded_counts(kernels) -> dict[str, int]:
    """K1-K4's and FA's launch counts."""
    from fusion_tpu_torch.ops import attention

    return {**{k: v for k, v in counts(*kernels).items() if k in ("K1", "K2", "K3", "K4")},
            "FA": attention.masked_attention_cuda.launches}


def reset_sharded_counts(kernels) -> None:
    from fusion_tpu_torch.ops import attention

    reset_counts(*kernels)
    attention.masked_attention_cuda.launches = 0


def sharded_one_rank(torch, np, src, queries, kernels, backend="nccl", device="cuda:0") -> dict:
    """[sharded] part 1: one rank on an NCCL group in this process; the
    sharded searcher against ``src`` (its shard is the corpus)."""
    import torch.distributed as dist

    from fusion_tpu_torch.parallel import sharding
    from fusion_tpu_torch.parallel.multihost import initialize_multihost
    from fusion_tpu_torch.serving_sharded import ShardedHybridSearcher

    initialize_multihost(f"127.0.0.1:{free_port()}", 1, 0, backend=backend, device=device)
    try:
        mesh = sharding.make_mesh(index=1)
        check(mesh.backend == backend and mesh.device == torch.device(device), f"sharded: mesh {mesh}")
        sh = ShardedHybridSearcher.from_searcher(src, mesh)
        sh.dense_impl = "fused"  # K2 per shard (JAX's sharded default is the exact block search)
        want = src.search_systems(queries, batch_size=BATCH, external_ids=False)
        got = sh.search_systems(queries, batch_size=BATCH, external_ids=False)
        legs = {n: overlap100(np, got[n].ids.numpy(), want[n].ids.numpy()) for n in want}
        check(set(got) == set(want) and all(v == 1.0 for v in legs.values()),
              f"sharded one rank: leg top-100 overlaps {legs}")
        want_f, _ = src.search(queries, batch_size=BATCH, external_ids=False)
        reset_sharded_counts(kernels)
        before = dict(sharding.COLLECTIVES)
        got_f, _ = sh.search(queries, batch_size=BATCH, external_ids=False)
        launches = sharded_counts(kernels)
        batches = len(queries) // BATCH
        check(np.array_equal(got_f.ids.numpy(), want_f.ids.numpy()),
              f"sharded one rank: fused top {TOPK} ids differ (overlap@100 "
              f"{overlap100(np, got_f.ids.numpy(), want_f.ids.numpy())})")
        check_ranked(torch, np, got_f, len(queries), TOPK, N_DOCS)
        for k in ("K2", "K3", "K4", "FA"):
            check(launches[k] > 0, f"sharded one rank: {k} never launched")
        single_ms, sharded_ms = [], []
        for _ in range(3):  # in turns
            single_ms += [t / batches for t in timed_ms(torch, lambda: src.search(queries, batch_size=BATCH), 1)]
            sharded_ms += [t / batches for t in timed_ms(torch, lambda: sh.search(queries, batch_size=BATCH), 1)]
        return {
            "backend": mesh.backend, "leg_top100_overlap": legs, "fused_ids_equal": True,
            "ms_per_batch_single": statistics.median(single_ms), "ms_per_batch_sharded": statistics.median(sharded_ms),
            "ms_per_batch_runs": {"single": single_ms, "sharded": sharded_ms},
            "collective_ms_per_batch": (sharding.COLLECTIVES["seconds"] - before["seconds"]) * 1e3 / batches,
            "collective_calls": sharding.COLLECTIVES["calls"] - before["calls"],
            "launches_per_batch": {k: v / batches for k, v in launches.items()},
        }
    finally:
        dist.destroy_process_group()
        sharding._DEFAULT_DEVICE[0] = None


def sharded_standalone(torch, np, src, mesh, batch, kernels) -> dict:
    """The six sharded functions of the index forms on this rank's shard of
    ``src``'s indexes against their single-device searches over the whole
    of them (every rank runs the same calls in the same order)."""
    from fusion_tpu_torch.index import inverted, plaid
    from fusion_tpu_torch.index.compression import CompressedTokenIndex, maxsim_search_compressed
    from fusion_tpu_torch.models.heads import l2_normalize
    from fusion_tpu_torch.ops import maxsim, mips, scatter_score
    from fusion_tpu_torch.parallel.sharding import INDEX_AXIS

    s, r = mesh.shape[INDEX_AXIS], mesh.coords[INDEX_AXIS]
    inputs = src._prepare_inputs(batch)
    out, k1 = {}, 0

    def held(name, got, want, atol):
        gi, gs, wi, ws = (x.cpu().numpy() for x in (got.ids, got.scores, want.ids, want.scores))
        fin = np.isfinite(ws) & np.isfinite(gs)
        out[name] = {"equal_up_to_ties": same_up_to_ties(np, gi, gs, wi, ws, atol),
                     "max_abs_score_diff": float(np.abs(np.where(fin, gs - ws, 0.0)).max()),
                     "top100_overlap": overlap100(np, gi, wi)}

    idx = src.bm25_impact_index
    terms, weights = inputs["bm25_terms"], inputs["bm25_weights"].float()
    got = inverted.sharded_impact_search(terms, weights, inverted.shard_impact_index(idx, s), mesh, k=TOPK)
    held("impact", got, inverted.impact_search(terms, weights, idx, k=got.depth), 0.0)

    dc = src.dense_corpus
    n = (src.dense_n_docs or dc.num_docs) // s * s
    emb = (dc.values[:n].float() * dc.scales[:n, None]).to(torch.bfloat16)
    q = src.dense_model.embed_tokens(inputs["q_ids"], inputs["q_mask"]).to(torch.bfloat16)
    per = n // s
    got = mips.sharded_dense_search(q, emb[r * per : (r + 1) * per], mesh, k=TOPK, similarity="dot_score")
    held("dense", got, mips.dense_search(q, emb, k=got.depth, similarity="dot_score"), 1e-5)
    del emb

    sp = src.splade_model.embed_tokens(inputs["sp_ids"], inputs["sp_mask"]).float()
    if src.splade_model.similarity == "cos_sim":
        sp = l2_normalize(sp)
    terms, weights = inverted.activations_to_query_terms(sp, src.splade_query_terms)
    sidx = src.splade_scatter_index
    got = scatter_score.sharded_scatter_search(terms, weights, scatter_score.shard_chunked_impact_index(sidx, s),
                                               mesh, k=TOPK)
    want = scatter_score.scatter_impact_search(terms, weights, sidx, k=got.depth)
    held("scatter", got, want, K3_TOL[0] + K3_TOL[1] * float(want.scores[torch.isfinite(want.scores)].abs().max()))

    ci = src.colbert_index
    q_tok = src.colbert_model.embed_tokens(inputs["cb_ids"], inputs["cb_mask"])
    qm = inputs["cb_mask"].float()
    n = ci.num_docs // s * s
    per = n // s
    rows = slice(r * per, (r + 1) * per)
    cid_tm, codes_tm, mask_tm, valid = ci.prepared()
    d_tm = ci.decompress_tm(cid_tm[:, :n], codes_tm[:, :n], mask_tm[:, :n])  # [Ld, N, D] bf16
    k1 -= maxsim.maxsim_maxima_cuda.launches
    got = mips.sharded_maxsim_search_tm(q_tok.to(torch.bfloat16), qm, d_tm[:, rows], valid[rows], mesh, k=TOPK)
    k1 += maxsim.maxsim_maxima_cuda.launches
    held("maxsim_tm", got, maxsim.maxsim_search_tm(q_tok.to(torch.bfloat16), qm, d_tm, valid[:n], k=got.depth), 1e-5)
    del d_tm
    shard = CompressedTokenIndex(ci.centroids, ci.centroid_ids[rows], ci.codes[rows], ci.mask[rows],
                                 ci.bucket_weights, ci.nbits)
    whole = CompressedTokenIndex(ci.centroids, ci.centroid_ids[:n], ci.codes[:n], ci.mask[:n], ci.bucket_weights,
                                 ci.nbits)
    k1 -= maxsim.maxsim_maxima_cuda.launches
    got = mips.sharded_maxsim_search_compressed(q_tok, qm, shard, mesh, k=TOPK)
    k1 += maxsim.maxsim_maxima_cuda.launches
    held("compressed", got, maxsim_search_compressed(q_tok, qm, whole, k=got.depth), 1e-5)

    k4 = -kernels[3].gather_rows_cuda.launches
    got = plaid.sharded_plaid_search(q_tok.float(), qm, plaid.shard_plaid_index(ci, s, ivf_cap=src.colbert_ivf.cap),
                                     mesh, k=TOPK, nprobe=src.plaid_nprobe, ncand=src.plaid_ncand)
    k4 += kernels[3].gather_rows_cuda.launches
    want = plaid.plaid_search(q_tok.float(), qm, ci, src.colbert_ivf, k=TOPK, nprobe=src.plaid_nprobe,
                              ncand=src.plaid_ncand)
    held("plaid", got, want, 1e-5)
    out["launches"] = {"K1": k1, "K4": k4}
    return out


def sharded_rank_main(rank: int, workdir: str, port: int, device: str = "cuda:0") -> int:
    """[sharded] part 2, one rank (a child process of this script): join the
    gloo group, load the parent's searcher, keep this rank's half, serve and
    check; write ``rank<r>.json``.  A failed check is recorded and the rank
    goes on, so both ranks make the same collective calls; the exit code
    says whether any failed."""
    import numpy as np
    import torch
    import torch.distributed as dist

    sys.path.insert(0, REPO)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    from fusion_tpu_torch.ops import _kernels, dense_topk, gather_rows, maxsim, scatter_score
    from fusion_tpu_torch.parallel import sharding
    from fusion_tpu_torch.parallel.multihost import initialize_multihost
    from fusion_tpu_torch.serving_sharded import ShardedHybridSearcher

    kernels = (maxsim, dense_topk, scatter_score, gather_rows)
    _kernels.load_all(["maxsim", "dense_topk", "scatter_score", "gather_rows", "attention"])  # built by the parent
    t0 = time.perf_counter()
    initialize_multihost(f"127.0.0.1:{port}", SHARDED_RANKS, rank, backend="gloo", device=device)
    mesh = sharding.make_mesh(index=SHARDED_RANKS, devices=[device] * SHARDED_RANKS)
    data = torch.load(os.path.join(workdir, "input.pt"), map_location=device, weights_only=False)
    src, queries = data["searcher"], data["queries"]
    torch.cuda.reset_peak_memory_stats()
    sh = ShardedHybridSearcher.from_searcher(src, mesh)
    sh.dense_impl = "fused"
    torch.cuda.synchronize()
    out = {"rank": rank, "backend": mesh.backend, "load_and_shard_s": time.perf_counter() - t0, "failed": []}

    def expect(cond, msg):
        if not cond:
            out["failed"].append(msg)

    batches = len(queries) // BATCH
    sh.search(queries[:BATCH], batch_size=BATCH)  # warm-up
    reset_sharded_counts(kernels)
    before = dict(sharding.COLLECTIVES)
    final, _ = sh.search(queries, batch_size=BATCH, external_ids=False)
    out["launches"] = sharded_counts(kernels)
    out["collective_ms_per_batch"] = (sharding.COLLECTIVES["seconds"] - before["seconds"]) * 1e3 / batches
    out["collective_bytes_per_batch"] = (sharding.COLLECTIVES["bytes"] - before["bytes"]) / batches
    out["collective_calls_per_batch"] = (sharding.COLLECTIVES["calls"] - before["calls"]) / batches
    # every rank runs each leg; FA runs where a rank's packed chunks hold rows
    for k in ("K2", "K3", "K4"):
        expect(out["launches"][k] > 0, f"{k} never launched on the sharded path")
    runs = [t / batches for t in timed_ms(torch, lambda: sh.search(queries, batch_size=BATCH), 3)]
    out["ms_per_batch"], out["ms_per_batch_runs"] = statistics.median(runs), runs

    fused, _ = dataclasses.replace(sh, rerank_depth=0).search(queries, batch_size=BATCH, external_ids=False)
    for ranked in (fused, final):
        ids, scores = ranked.ids.numpy(), ranked.scores.numpy()
        expect(ids.shape == (len(queries), TOPK) and bool(np.isfinite(scores).all())
               and bool((np.diff(scores, axis=1) <= 0).all()) and bool(((ids >= 0) & (ids < N_DOCS)).all())
               and all(len(set(row)) == len(row) for row in ids), "the fused list is not well formed")
    depth = sh.rerank_depth
    expect(all(set(a[:depth]) == set(b[:depth]) for a, b in zip(final.ids.numpy(), fused.ids.numpy())),
           "the reranked head is not a permutation of the fused head")
    out["final_ids_head"] = final.ids[:2, :10].tolist()

    legs = sh.search_systems(queries, batch_size=BATCH, external_ids=False)
    launched = sharded_counts(kernels)
    with plain_kernels():
        plain = sh.search_systems(queries, batch_size=BATCH, external_ids=False)
        inputs = sh._prepare_inputs(queries[:BATCH])
        head = sh._fuse(sh._search_batch(inputs)).ids[:, :depth]
        logits_plain = sh._packed_rerank_stage(inputs, head)
    expect(sharded_counts(kernels) == launched, "the plain versions launched a kernel")
    logits = sh._packed_rerank_stage(inputs, head)
    valid = head >= 0
    out["fa_logit_gap_vs_plain"] = float((logits - logits_plain)[valid].abs().max())
    expect(out["fa_logit_gap_vs_plain"] <= RERANK_LOGIT_TOL, f"FA logits vs plain {out['fa_logit_gap_vs_plain']}")
    out["leg_top100_overlap_vs_plain"] = {n: overlap100(np, legs[n].ids.numpy(), plain[n].ids.numpy()) for n in legs}
    for n, v in out["leg_top100_overlap_vs_plain"].items():
        expect(v >= 0.99, f"{n} leg kernel vs plain top-100 overlap {v}")
    single = src.search_systems(queries, batch_size=BATCH, external_ids=False)
    out["bm25_equal_single_device"] = bool(torch.equal(legs["bm25"].ids, single["bm25"].ids)
                                           and torch.equal(legs["bm25"].scores, single["bm25"].scores))
    expect(out["bm25_equal_single_device"], "BM25's merged list differs from the single-device list")
    out["leg_top100_overlap_vs_single"] = {n: overlap100(np, legs[n].ids.numpy(), single[n].ids.numpy())
                                           for n in legs}
    out["merged_lists_digest"] = {n: float(legs[n].scores[torch.isfinite(legs[n].scores)].double().sum())
                                  for n in legs}

    standalone = sharded_standalone(torch, np, src, mesh, queries[:BATCH], kernels)
    out["standalone"] = standalone
    for name in ("impact", "dense", "scatter", "maxsim_tm", "compressed"):
        expect(standalone[name]["equal_up_to_ties"], f"sharded {name} search vs single-device: {standalone[name]}")
    for name, n in standalone["launches"].items():
        expect(n > 0, f"the sharded functions never launched {name}")
    out["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2**30
    t0 = time.perf_counter()
    out["server"] = sharded_server_rank(torch, np, sh, queries, kernels, expect)
    out["server"]["s"] = time.perf_counter() - t0
    with open(os.path.join(workdir, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    dist.barrier()
    dist.destroy_process_group()
    return 1 if out["failed"] else 0


# [sharded_server]: the requests (the slice's queries, the first
# SHARDED_SERVER_REPEATS of them again, topk by turns), the client threads,
# and the mean top-k overlap the answers must keep with the searcher's own
# lists in the slice's batches (a query rides in another batch there: the
# packed rerank packs its pairs among others, FA sums their keys in another
# order, and K3's atomics vary; the random-weight cross-encoder's logits lie
# close, so its order moves: mean 0.920, least 0.6 on an H100, NVIDIA H100
# 80GB HBM3 at 700 W; the gate catches a wrong fan-out, near 0, not that noise)
SHARDED_SERVER_REPEATS, SHARDED_SERVER_CLIENTS, SHARDED_SERVER_TOPKS = 32, 32, (3, 5, 10)
SHARDED_SERVER_MEAN_OVERLAP = 0.75

# the clients of [sharded_server]: argv = base url, a JSON file of request
# bodies, the thread count; prints one JSON object with (request, results,
# ms) per request
_BODY_CLIENTS = """
import concurrent.futures, json, sys, time, urllib.request
url, path, threads = sys.argv[1], sys.argv[2], int(sys.argv[3])
bodies = json.load(open(path))
def one(i):
    t = time.perf_counter()
    req = urllib.request.Request(url + "/search", data=json.dumps(bodies[i]).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=300) as r:
        res = json.loads(r.read())["results"]
    return i, res, (time.perf_counter() - t) * 1000
t0 = time.perf_counter()
with concurrent.futures.ThreadPoolExecutor(threads) as pool:
    answers = list(pool.map(one, range(len(bodies))))
print(json.dumps({"wall_s": time.perf_counter() - t0, "answers": answers}))
"""


def sharded_server_rank(torch, np, sh, queries, kernels, expect) -> dict:
    """[sharded_server] on this rank: a SearchServer over the two-rank
    searcher ``sh`` on both ranks (max_batch BATCH), rank 0 listening on
    127.0.0.1 and driving ``sharded_server_clients``.  Every batch the
    server runs is recorded on both ranks with its lists (the searcher's
    own); the ranks must run the same batches.  The launch counts are set
    to 0 just before the server starts (its warm-up included) and read
    after it stops; the collectives are counted over the same span."""
    from fusion_tpu_torch.parallel import sharding
    from fusion_tpu_torch.server import SearchServer

    direct, _ = sh.search(queries, batch_size=BATCH)
    search, ran = sh.search, []

    def recording(batch, batch_size=32, **kw):  # both ranks run the same calls
        if "RAISE" in batch:
            raise ValueError("a batch that raises on every rank")
        ranked, ms = search(batch, batch_size=batch_size, **kw)
        ran.append((list(batch), ranked.ids.cpu().numpy(), ranked.scores.cpu().numpy()))
        return ranked, ms

    out: dict = {}
    sh.search = recording
    try:
        reset_sharded_counts(kernels)
        before = dict(sharding.COLLECTIVES)
        t0 = time.perf_counter()
        srv = SearchServer(sh, host="127.0.0.1", port=0, max_batch=BATCH, max_wait_ms=5.0)
        srv.start()
        out["start_s"] = time.perf_counter() - t0
        try:
            if srv.leader:
                host, port = srv.address
                out.update(sharded_server_clients(np, f"http://{host}:{port}", queries, direct.ids.cpu().numpy(),
                                                  ran, expect))
        finally:
            srv.stop()  # on rank 1: returns when rank 0's stop arrives
    finally:
        sh.search = search
    out["launches"] = sharded_counts(kernels)
    coll = {k: sharding.COLLECTIVES[k] - before[k] for k in before}
    out["searches"] = len(ran)  # the warm-up and every batch, on this rank
    out["batch_digest"] = [len(batch) for batch, _, _ in ran]
    out["collective_ms_per_batch"] = coll["seconds"] * 1e3 / max(len(ran), 1)
    out["collective_mb_per_batch"] = coll["bytes"] / 1e6 / max(len(ran), 1)
    out["collective_calls_per_batch"] = coll["calls"] / max(len(ran), 1)
    for name in ("K2", "K3", "K4"):
        expect(out["launches"][name] > 0, f"sharded_server: {name} never launched")
    return out


def sharded_server_clients(np, url, queries, d_ids, ran, expect) -> dict:
    """[sharded_server]'s requests to the leader at ``url``: the slice's
    queries one a request, the first SHARDED_SERVER_REPEATS again, topk by
    turns, from SHARDED_SERVER_CLIENTS threads in a process of their own.
    Each answer must be its query's row in a batch the server ran (``ran``:
    ids exact, scores within the server's rounding), and the answers keep
    a mean top-k overlap of SHARDED_SERVER_MEAN_OVERLAP with ``d_ids``, the
    searcher's lists in the slice's batches.  Then a batch that raises on both ranks
    gets a 500, the next request is served, and /healthz counts the whole
    corpus."""
    import urllib.error
    import urllib.request

    def rows(q):  # q's lists in every batch it rode in
        return [(b_ids[j], b_scores[j]) for batch, b_ids, b_scores in ran for j, bq in enumerate(batch) if bq == q]

    topks = SHARDED_SERVER_TOPKS
    bodies = [{"queries": [queries[i % len(queries)]], "topk": topks[i % len(topks)]}
              for i in range(len(queries) + SHARDED_SERVER_REPEATS)]
    with tempfile.NamedTemporaryFile("w", suffix=".json", delete=False) as f:
        json.dump(bodies, f)
    try:
        run = subprocess.run([sys.executable, "-c", _BODY_CLIENTS, url, f.name, str(SHARDED_SERVER_CLIENTS)],
                             capture_output=True, text=True, timeout=600)
    finally:
        os.unlink(f.name)
    check(run.returncode == 0, f"sharded_server: the clients failed: {run.stderr[-2000:]}")
    clients = json.loads(run.stdout)
    exact, overlaps = 0, []
    for i, results, _ in clients["answers"]:
        q, k = bodies[i]["queries"][0], bodies[i]["topk"]
        ids, scores = results[0]["ids"], np.asarray(results[0]["scores"])
        exact += any(len(ids) == k and ids == r_ids[:k].tolist() and bool(np.abs(scores - r_sc[:k]).max() <= 1e-5)
                     for r_ids, r_sc in rows(q))
        overlaps.append(len(set(ids) & set(d_ids[queries.index(q)][:k].tolist())) / k)
    expect(exact == len(bodies), f"sharded_server: {len(bodies) - exact} of {len(bodies)} answers are not their "
           "batch's own lists")
    expect(np.mean(overlaps) >= SHARDED_SERVER_MEAN_OVERLAP,
           f"sharded_server: mean top-k overlap with the slice's batches {np.mean(overlaps)}")
    lat = sorted(a[2] for a in clients["answers"])
    out = {"requests": len(bodies), "answers_exact": exact, "client_threads": SHARDED_SERVER_CLIENTS,
           "requests_per_s": len(bodies) / clients["wall_s"], "p50_request_ms": lat[len(lat) // 2],
           "p99_request_ms": lat[min(len(lat) - 1, int(0.99 * len(lat)))],
           "topk_overlap_vs_slice_batches": {"min": min(overlaps), "mean": float(np.mean(overlaps))}}
    try:
        _post(f"{url}/search", {"queries": ["RAISE"], "topk": 3})
        expect(False, "sharded_server: the raising batch was answered")
    except urllib.error.HTTPError as e:
        out["raising_batch"] = {"code": e.code, "error": json.loads(e.read()).get("error")}
        expect(e.code == 500, f"sharded_server: the raising batch got HTTP {e.code}")
    after = _post(f"{url}/search", {"queries": [queries[0]], "topk": 10})["results"][0]["ids"]
    out["served_after_500"] = any(after == r_ids[:10].tolist() for r_ids, _ in rows(queries[0]))
    expect(out["served_after_500"], "sharded_server: the request after the 500 got another list")
    with urllib.request.urlopen(f"{url}/healthz", timeout=60) as r:
        out["healthz_corpus_docs"] = json.loads(r.read())["corpus_docs"]
    expect(out["healthz_corpus_docs"] == N_DOCS, f"sharded_server: /healthz {out['healthz_corpus_docs']}")
    with urllib.request.urlopen(f"{url}/stats", timeout=60) as r:
        stats = json.loads(r.read())
    out.update(batches=stats["batches"], errors=stats["errors"], mean_batch_ms=stats["mean_batch_ms"])
    expect(stats["batches"] < stats["requests"], f"sharded_server: {stats['batches']} batches for "
           f"{stats['requests']} requests")
    return out


def run_ranks(label: str, work: str, ranks: int, timeout: float, device: str) -> list[dict]:
    """Start ``ranks`` children of this script (``--{label}-rank r``, one
    gloo group on ``device``), wait for them (killing them past
    ``timeout``), fail on a timeout or a non-zero exit with the tails of
    their logs, and return each rank's ``rank<r>.json``."""
    port, procs, logs = free_port(), [], []
    for rank in range(ranks):
        logs.append(os.path.join(work, f"rank{rank}.log"))
        with open(logs[-1], "w") as log:
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), f"--{label}-rank", str(rank), "--rank-dir", work,
                 "--rank-port", str(port), "--rank-device", device], stdout=log, stderr=subprocess.STDOUT, cwd=REPO,
            ))
    deadline = time.monotonic() + timeout
    timed_out = False
    try:
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        timed_out = True
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    tails = "\n".join(f"--- rank {r}:\n{open(log).read()[-4000:]}" for r, log in enumerate(logs))
    check(not timed_out, f"{label}: the ranks outlived {timeout} s\n{tails}")
    reports = []
    for rank, p in enumerate(procs):
        path = os.path.join(work, f"rank{rank}.json")
        report = json.load(open(path)) if os.path.exists(path) else {}
        check(p.returncode == 0, f"{label}: rank {rank} exited {p.returncode}: {report.get('failed')}\n{tails}")
        reports.append(report)
    return reports


def sharded_two_ranks(torch, src, queries, device="cuda:0") -> list[dict]:
    """[sharded] part 2: save ``src`` and the queries, start the two ranks
    (children of this script, one gloo group on cuda:0), wait for both."""
    with tempfile.TemporaryDirectory(prefix="chip_smoke_sharded_") as work:
        t0 = time.perf_counter()
        torch.save({"searcher": src, "queries": list(queries)}, os.path.join(work, "input.pt"))
        save_s = time.perf_counter() - t0
        reports = run_ranks("sharded", work, SHARDED_RANKS, SHARDED_TIMEOUT, device)
        reports[0]["save_s"] = save_s
        return reports


def sharded_check(torch, np, src, queries, kernels, backend="nccl", device="cuda:0") -> dict:
    """[sharded]: the one-rank NCCL part, then the two-rank gloo part."""
    t0 = time.perf_counter()
    out = {"one_rank": sharded_one_rank(torch, np, src, queries, kernels, backend, device)}
    out["one_rank"]["s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    ranks = sharded_two_ranks(torch, src, queries, device)
    check(ranks[0]["merged_lists_digest"] == ranks[1]["merged_lists_digest"]
          and ranks[0]["final_ids_head"] == ranks[1]["final_ids_head"], "sharded: the two ranks' lists differ")
    check(sum(r["launches"]["FA"] for r in ranks) > 0, "sharded: FA never launched on the sharded path")
    servers = [r["server"] for r in ranks]
    check(servers[0]["batch_digest"] == servers[1]["batch_digest"], "sharded_server: the ranks ran other batches")
    check(sum(v["launches"]["FA"] for v in servers) > 0, "sharded_server: FA never launched")
    out["server"] = {
        **{k: v for k, v in servers[0].items() if k not in ("launches", "batch_digest")},
        "launches_per_rank": [v["launches"] for v in servers],
        "per_rank": [{k: v[k] for k in ("collective_ms_per_batch", "collective_mb_per_batch",
                                        "collective_calls_per_batch", "searches", "s")} for v in servers],
    }
    out["two_ranks"] = {
        "s": time.perf_counter() - t0 - servers[0]["s"], "backend": ranks[0]["backend"],
        "note": "two ranks share one card's SMs: these times are no speed-up figure",
        **{k: ranks[0][k] for k in ("leg_top100_overlap_vs_plain", "leg_top100_overlap_vs_single",
                                    "bm25_equal_single_device", "fa_logit_gap_vs_plain", "standalone", "save_s")},
        "launches": {k: sum(r["launches"][k] for r in ranks) for k in ranks[0]["launches"]},
        "launches_per_rank": [r["launches"] for r in ranks],
        "plaid_top100_overlap_vs_single": ranks[0]["leg_top100_overlap_vs_single"]["colbert"],
        "per_rank": [{k: r[k] for k in ("ms_per_batch", "ms_per_batch_runs", "collective_ms_per_batch",
                                        "collective_bytes_per_batch", "collective_calls_per_batch", "peak_mem_gib",
                                        "load_and_shard_s")} for r in ranks],
    }
    return out


# ----------------------------------------------------------------------
# [train_parallel]: data- and tensor-parallel training, two ranks on the card
# ----------------------------------------------------------------------
# run → (family, data ranks, model ranks, attention form); shapes by family:
# (global batch, query length, doc length, negatives per query).  X-MOD
# SPLADE's batch is cut to 8 queries: its logits span xmod-base's 250,002
# terms, and one rank's f64 reference at 2 layers holds [2,304 tokens,
# 250,002] several times.  T5 has no flash form (its attention is the
# einsum with the relative bias) and trains at the CLI's monoBERT pair length.
TRAIN_PARALLEL_RUNS = {
    "colbert_data2": ("colbert", 2, 1, "flash"),
    "dpr_data2": ("dpr", 2, 1, "einsum"),
    "colbert_model2": ("colbert", 1, 2, "flash"),
    "xmod_splade_model2": ("xmod_splade", 1, 2, "flash"),
    "t5_model2": ("t5", 1, 2, "einsum"),
}
TRAIN_PARALLEL_SHAPES = {"colbert": (32, 32, 256, 3), "dpr": (32, 64, 256, 1), "xmod_splade": (8, 32, 128, 1),
                         "t5": (32, 0, 256, 0)}
XMOD_LANGUAGES = ("fr_XX", "en_XX")  # the adapters; the runs train through fr_XX
# the bf16 pass's depth (cut from 12 to 6, then to 4 to make room for
# [examples], [tpu_tests] and [chunked_impact], to keep the script inside
# its time limit: ColBERT and X-MOD SPLADE on model = 2 took 28 s and 104 s
# at 12 layers, nearly all of it in gloo's per-layer all-reduces and X-MOD's
# 1.5 GB gather of the sliced leaves)
TRAIN_PARALLEL_BF16_LAYERS = 4
# steps a pass: two in the f32 pass, whose second step's loss, parameters
# and update are held to one rank's (the sharded Adam state carried across
# a step); one in the bf16 pass (cut from 2 to keep the script inside its
# time limit: a step's cost at full depth is X-MOD's bf16 gathers)
TRAIN_PARALLEL_F32_STEPS, TRAIN_PARALLEL_BF16_STEPS, TRAIN_PARALLEL_LR = 2, 1, 1e-3
TRAIN_PARALLEL_RANKS, TRAIN_PARALLEL_TIMEOUT = 2, 600
# the bf16 pass against one rank's bf16 step over the global batch, at the
# same weights: the step's loss (relative), the gradient before the
# optimizer (per leaf ||a - b|| / ||b||, and over all leaves at once), and
# the parallel gradient's distance to the f32 one at the same depth over
# one rank's.  Read on an H100 at 12 layers (ColBERT data 2 / DPR data 2 /
# ColBERT model 2):
# loss 0 / 0 / 8.7e-4, worst leaf 0.099 / 0.23 / 0.27, all leaves 0.028 /
# 0.054 / 0.19, ratio 0.99 / 0.99 / 0.90, where one rank's bf16 gradient is
# itself 0.13 / 0.19 / 0.18 from the f32 one: bf16 rounding at 12 layers.
# A wrong sum or a wrong head slice moves each by O(1).
TRAIN_PARALLEL_BF16_GATES = {"loss_rel": 5e-3, "grad_max_rel": 0.5, "grad_rel": 0.35, "grad_rel_vs_f32_ratio": 1.5}
# X-MOD SPLADE's bf16 gradient is far noisier: SPLADE's max over 250,002
# terms routes each term's gradient to one token, and bf16 flips near-ties.
# Read on an H100 (NVIDIA H100 80GB HBM3, 700 W): one rank's own bf16
# gradient stands 0.30 (all leaves) / 0.80 (worst leaf) from the f32 one,
# so two bf16 gradients may stand up to twice that apart; its gradient
# gates are twice the run's own reference distance to f32 (or the gates
# above, where larger), and its loss and ratio gates are the ones above.


def bf16_gates(family, res) -> dict:
    """The bf16 pass's gates for ``family`` in the run ``res``."""
    gates = dict(TRAIN_PARALLEL_BF16_GATES)
    if family == "xmod_splade":
        ref = res["bf16"]["f32"]
        gates["grad_rel"] = max(gates["grad_rel"], 2 * ref["reference_grad_rel"])
        gates["grad_max_rel"] = max(gates["grad_max_rel"], 2 * ref["reference_max_rel"])
    return gates


def train_parallel_config(torch, form, dtype, layers=None, family="colbert"):
    """``family``'s trunk at full width computing in ``dtype`` over f32
    master weights, dropout 0, at ``layers`` layers (None: the full depth):
    CamemBERT-base, or xmod-base (``XmodConfig``'s defaults, the adapters
    of XMOD_LANGUAGES) with remat; T5 at the CLI's ``--backbone t5`` widths
    (``T5Config(vocab_size=32,005)``: 6 layers, no remat)."""
    from fusion_tpu_torch.models.encoder import EncoderConfig
    from fusion_tpu_torch.models.t5 import T5Config
    from fusion_tpu_torch.models.xmod import XmodConfig

    depth = {} if layers is None else {"num_layers": layers}
    if family == "t5":
        return T5Config(vocab_size=SPLADE_VOCAB, dtype=dtype, **depth)
    build = XmodConfig if family == "xmod_splade" else EncoderConfig
    extra = {"languages": XMOD_LANGUAGES} if family == "xmod_splade" else {}
    return build(dtype=dtype, remat=True, dropout=0.0, attention_impl=form, **depth, **extra)


def parallel_step_flops(cfg, family, b, lq, ld, n_neg) -> float:
    """The model FLOPs of one train step of ``family``: ``profiling``'s for
    the BERT-style families (X-MOD SPLADE as SPLADE, plus its adapters: 4 H
    × the bottleneck a token a layer); for T5, 3 × the forward of its
    projections (q, k, v, o: 8 d·inner a token; the FFN 4 d·d_ff), its
    attention (4 L² inner a sequence) and the head, a layer at a time."""
    from fusion_tpu_torch.utils import profiling

    if family == "t5":
        inner = cfg.num_heads * cfg.d_kv
        layer = b * (ld * (8 * cfg.d_model * inner + 4 * cfg.d_model * cfg.d_ff) + 4 * ld * ld * inner)
        return 3 * (cfg.num_layers * layer + b * 2 * cfg.d_model * cfg.d_model)
    model, _ = profiling.train_step_flops(cfg, "splade" if family == "xmod_splade" else family, b, lq, ld, n_neg, DIM)
    if family == "xmod_splade":
        tokens = b * lq + b * (1 + n_neg) * ld
        model += 3 * tokens * cfg.num_layers * 4 * cfg.hidden_size * cfg.bottleneck_size
    return model


def whole_grads(torch, family, model, batch, mesh) -> tuple[float, dict]:
    """(loss, gradient) of ``family``'s loss over ``batch`` (this rank's rows
    under ``mesh``), the gradient as the parallel step forms it
    (``trainer.reduce_gradients``), whole, by parameter name on the host."""
    from fusion_tpu_torch.train import trainer

    loss, _ = train_loss(family, model, batch, 0, mesh=mesh)
    loss.backward()
    params = dict(model.module.named_parameters())
    grads, whole, _ = trainer.reduce_gradients(params, mesh)
    out = {n: g.detach().float().cpu() for n, g in grads.items() if n not in whole}
    out.update({n: params[n].tp_shard.layout.from_flax(w).float().cpu() for n, w in whole.items()})
    for p in params.values():
        p.grad = None
    return loss.item(), out


def grad_gaps(got: dict, want: dict) -> dict:
    """Per leaf ||got - want|| / ||want||: the worst leaf and its gap, and
    the gap over all leaves at once."""
    rel = {n: float((got[n] - want[n]).norm() / max(float(want[n].norm()), 1e-30)) for n in want}
    worst = max(rel, key=rel.get)
    num = sum(float((got[n] - want[n]).norm()) ** 2 for n in want) ** 0.5
    den = sum(float(want[n].norm()) ** 2 for n in want) ** 0.5
    return {"grad_max_rel": rel[worst], "grad_worst_leaf": worst, "grad_rel": num / den, "rel": rel}


def param_gaps(got: dict, want: dict) -> dict:
    """The largest |got - want| of a parameter after the steps, over the lr."""
    apart = {k: float((got[k] - want[k]).abs().max()) / TRAIN_PARALLEL_LR for k in want}
    far = max(apart, key=apart.get)
    return {"param_max_abs_over_lr": apart[far], "param_farthest_leaf": far,
            "params_over_0.2_lr": {k: v for k, v in apart.items() if v > 0.2}}


def train_parallel_run(torch, np, name, rank, device) -> dict:
    """One run of [train_parallel] on this rank, from the same seed and
    global batch, in two passes; in each, rank 0 first takes the reference
    (one rank's gradient and the pass's steps over the global batch, alone
    on the card), then both ranks place the model on the run's
    mesh and take the gradient and the steps, and rank 0 holds them to the
    reference.
      * f32 at 2 layers, TRAIN_PARALLEL_F32_STEPS steps, at ``AGREE_GATES``
        ([train_agreement]): the loss of each step, the gradient, the
        parameters and the update (per leaf, by the norm of the steps'
        update) after the steps.  The same
        gradient in f64 (the einsum form; its gap to f32's is the f32
        rounding) tells a leaf that rounds badly from a wrong sum.
      * bf16 at TRAIN_PARALLEL_BF16_LAYERS layers, one step (the measured
        pass, through FA and FA-bwd at 12 or 6 heads a rank):
        the step's loss and the gradient, at ``bf16_gates``; and both bf16
        gradients against the f32 one of the einsum form at that depth (one
        rank), where the parallel
        one may stand at most ``grad_rel_vs_f32_ratio`` times as far as one
        rank's.  The parameters after the steps are reported, not
        gated: the ranks' products sum in another order than one device's,
        and Adam's first steps move a leaf by about the lr whatever the size
        of its gradient, so where bf16 rounding flips a small gradient's
        sign the leaves end the lr apart.
    Then ms, the collectives, peak memory and MFU of the bf16 steps.  In
    each parallel pass FA's and FA-bwd's counts are set to 0 just before the
    steps and read just after."""
    import torch.distributed as dist

    from fusion_tpu_torch.ops.attention import masked_attention_backward_cuda, masked_attention_cuda
    from fusion_tpu_torch.parallel import sharding
    from fusion_tpu_torch.train import trainer
    from fusion_tpu_torch.utils import profiling

    family, data, model_ranks, form = TRAIN_PARALLEL_RUNS[name]
    b, lq, ld, n_neg = TRAIN_PARALLEL_SHAPES[family]
    seed = 400 + list(TRAIN_PARALLEL_RUNS).index(name)
    host = train_batch(np, family, b, lq, ld, n_neg,
                       train_parallel_config(torch, form, torch.float32, family=family).vocab_size, seed)
    fit_cfg = trainer.FitConfig(steps=TRAIN_PARALLEL_F32_STEPS, learning_rate=TRAIN_PARALLEL_LR,
                                scheduler="constant")
    mesh = sharding.make_mesh(data=data, model=model_ranks, devices=[device] * TRAIN_PARALLEL_RANKS)
    # the seed's f32 master weights by depth, drawn once on the host: every
    # pass of a depth starts from them (xmod-base's take ~9 s to draw)
    initial: dict = {}

    def run(cfg, mesh, steps):
        model = train_model(torch, family, cfg, seed, device, initial.get(cfg.num_layers))
        if cfg.num_layers not in initial:
            initial[cfg.num_layers] = {k: v.detach().to("cpu", copy=True) for k, v in model.module.state_dict().items()}
        state, tx, _ = trainer.init_train_state(model, fit_cfg)
        step = train_step_fn(family, model, tx, fit_cfg.steps, mesh=mesh)
        if mesh is not None:
            state = step.place_state(state)
        batch = trainer._to_device(host, model.device)
        local = batch if mesh is None else {k: trainer._local_rows(v, mesh) for k, v in batch.items()}
        loss, grads = whole_grads(torch, family, model, local, mesh)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = dict(sharding.COLLECTIVES)
        masked_attention_cuda.launches = masked_attention_backward_cuda.launches = 0
        times, losses = [], []
        for _ in range(steps):
            t0 = time.perf_counter()
            state, metrics = step(state, batch)
            losses.append(metrics["loss"].item())
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1000)
        launches = {"FA": masked_attention_cuda.launches, "FA-bwd": masked_attention_backward_cuda.launches}
        stats = {"peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30, "times": times, "launches": launches,
                 "collectives": {k: sharding.COLLECTIVES[k] - before[k] for k in before}, "grad_loss": loss}
        with trainer.whole_parameters(model, mesh):
            params = {k: v.detach().float().cpu() for k, v in model.module.state_dict().items()}
        del model, state, tx, step, batch, local
        gc.collect()
        torch.cuda.empty_cache()
        return losses, grads, params, stats

    def update(params):
        """The parameters' move from the f32 pass's starting weights."""
        return {k: v - initial[2][k].float() for k, v in params.items()}

    depth = TRAIN_PARALLEL_BF16_LAYERS
    f32 = train_parallel_config(torch, form, torch.float32, 2, family)
    bf16 = train_parallel_config(torch, form, torch.bfloat16, depth, family)
    f64 = train_parallel_config(torch, "einsum", torch.float64, 2, family)
    t0 = time.perf_counter()
    if rank == 0:
        reference = run(f32, None, TRAIN_PARALLEL_F32_STEPS)
        exact = run(f64, None, 0)[1]
        bf16_exact = run(train_parallel_config(torch, "einsum", torch.float32, depth, family), None, 0)[1]
    dist.barrier()
    t1 = time.perf_counter()
    losses, grads, params, stats = run(f32, mesh, TRAIN_PARALLEL_F32_STEPS)
    t2 = time.perf_counter()
    bf16_reference = run(bf16, None, TRAIN_PARALLEL_BF16_STEPS) if rank == 0 else None
    dist.barrier()
    t3 = time.perf_counter()
    bf16_losses, bf16_grads, bf16_params, bf16_stats = run(bf16, mesh, TRAIN_PARALLEL_BF16_STEPS)
    pass_s = {"references_f32_f64": t1 - t0, "parallel_f32": t2 - t1, "reference_bf16": t3 - t2,
              "parallel_bf16": time.perf_counter() - t3}
    steps, ms = TRAIN_PARALLEL_BF16_STEPS, bf16_stats["times"][-1]
    model_flops = parallel_step_flops(bf16, family, b, lq, ld, n_neg)
    coll = bf16_stats["collectives"]
    out = {
        "mesh": f"data{data}xmodel{model_ranks}", "form": form, "bf16_layers": bf16.num_layers,
        "shape": f"B{b}xLq{lq}xLd{ld}xneg{n_neg}",
        # T5's trunk is whole on every model rank (no rule splits its leaves)
        "heads_per_rank": bf16.num_heads // (1 if family == "t5" else model_ranks),
        "ms_per_step": ms, "ms_steps": bf16_stats["times"], "losses": bf16_losses, "f32_losses": losses,
        "f32_ms_steps": stats["times"],
        "collective_ms_per_step": coll["seconds"] * 1e3 / steps, "collective_mb_per_step": coll["bytes"] / 1e6 / steps,
        "collective_calls_per_step": coll["calls"] / steps, "peak_mem_gib": bf16_stats["peak_mem_gib"],
        # each rank does half the step's work, on a card the two share
        "mfu": profiling.utilization(model_flops / TRAIN_PARALLEL_RANKS, ms / 1000),
        "launches": bf16_stats["launches"], "f32_launches": stats["launches"],
        "fa_per_step": bf16_stats["launches"]["FA"] / steps,
        "fa_bwd_per_step": bf16_stats["launches"]["FA-bwd"] / steps,
        "params_digest": [float(sum(p.double().sum() for p in ps.values())) for ps in (params, bf16_params)],
        "pass_s": pass_s,
    }
    if rank == 0:
        ref_losses, ref_grads, ref_params, ref_stats = reference
        gaps = grad_gaps(grads, ref_grads)
        worst = gaps["grad_worst_leaf"]
        ref_exact, par_exact = grad_gaps(ref_grads, exact), grad_gaps(grads, exact)
        out.update({
            "reference_f32_ms_steps": ref_stats["times"], "reference_f32_losses": ref_losses,
            "loss_rel": max(abs(a - r) / abs(r) for a, r in zip(losses, ref_losses)),
            **{k: v for k, v in gaps.items() if k != "rel"},
            **param_gaps(params, ref_params),
            "update_max_rel": _max_rel(update(params), update(ref_params)),
            # each f32 gradient against the f64 one: the worst leaf, and the
            # f32 pair's worst leaf
            "f64": {"reference_max_rel": ref_exact["grad_max_rel"], "reference_worst_leaf": ref_exact["grad_worst_leaf"],
                    "parallel_max_rel": par_exact["grad_max_rel"], "parallel_worst_leaf": par_exact["grad_worst_leaf"],
                    "at_f32_worst_leaf": {"reference": ref_exact["rel"][worst], "parallel": par_exact["rel"][worst]}},
        })
        ref_losses, ref_grads, ref_params, ref_stats = bf16_reference
        gaps = grad_gaps(bf16_grads, ref_grads)
        ref_exact, par_exact = grad_gaps(ref_grads, bf16_exact), grad_gaps(bf16_grads, bf16_exact)
        out["bf16"] = {
            "reference_losses": ref_losses, "reference_ms_steps": ref_stats["times"],
            "loss_rel": abs(bf16_losses[0] - ref_losses[0]) / abs(ref_losses[0]),
            "grad_loss_rel": abs(bf16_stats["grad_loss"] - ref_stats["grad_loss"]) / abs(ref_stats["grad_loss"]),
            **{k: v for k, v in gaps.items() if k != "rel"},
            "grad_rel_by_leaf_top5": dict(sorted(gaps["rel"].items(), key=lambda kv: -kv[1])[:5]),
            **param_gaps(bf16_params, ref_params),
            # each bf16 gradient against the f32 one at the same depth
            "f32": {"reference_grad_rel": ref_exact["grad_rel"], "parallel_grad_rel": par_exact["grad_rel"],
                    "reference_max_rel": ref_exact["grad_max_rel"], "parallel_max_rel": par_exact["grad_max_rel"],
                    "parallel_worst_leaf": par_exact["grad_worst_leaf"]},
            "grad_rel_vs_f32_ratio": par_exact["grad_rel"] / ref_exact["grad_rel"],
        }
        out["bf16"]["params_over_0.2_lr"] = len(out["bf16"]["params_over_0.2_lr"])
    return out


def train_parallel_rank_main(rank: int, workdir: str, port: int, device: str = "cuda:0") -> int:
    """[train_parallel], one rank (a child process of this script): join
    the gloo group, run each of TRAIN_PARALLEL_RUNS, write ``rank<r>.json``.
    An exception ends the rank with a non-zero exit (its partner's next
    collective then fails or times out); a check that fails is recorded,
    the rank goes on, and its exit code says so."""
    import numpy as np
    import torch
    import torch.distributed as dist

    sys.path.insert(0, REPO)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    from fusion_tpu_torch.ops import _kernels
    from fusion_tpu_torch.parallel.multihost import initialize_multihost

    _kernels.load_all(["attention"])  # built by the parent
    initialize_multihost(f"127.0.0.1:{port}", TRAIN_PARALLEL_RANKS, rank, backend="gloo", device=device)
    out = {"rank": rank, "failed": [], "runs": {}}
    for name, (family, _, _, form) in TRAIN_PARALLEL_RUNS.items():
        t0 = time.perf_counter()
        res = train_parallel_run(torch, np, name, rank, device)
        res["s"] = time.perf_counter() - t0
        out["runs"][name] = res
        print(f"[train_parallel rank {rank}] {name} {res['s']:.1f}s "
              + json.dumps({k: v for k, v in res.items() if k not in ("params_digest",)}), flush=True)
        # per step: 3 forwards × the layers × 2 (the remat recompute), 3 × the layers backward
        for label, layers, steps in (("launches", res["bf16_layers"], TRAIN_PARALLEL_BF16_STEPS),
                                     ("f32_launches", 2, TRAIN_PARALLEL_F32_STEPS)):
            per_step = {"FA": steps * 6 * layers, "FA-bwd": steps * 3 * layers}
            if form == "flash" and res[label] != per_step:
                out["failed"].append(f"{name}: {label} {res[label]} in {steps} steps (want "
                                     f"{6 * layers} / {3 * layers} a step)")
            if form != "flash" and res[label] != {"FA": 0, "FA-bwd": 0}:
                out["failed"].append(f"{name}: the {form} form launched the attention kernels: {res[label]}")
        if not all(np.isfinite(res["losses"] + res["f32_losses"])):
            out["failed"].append(f"{name}: losses {res['losses']}")
        if rank == 0:
            gates = {"loss_rel": AGREE_LOSS_RTOL, **AGREE_GATES[AGREE_FAMILY.get(family, family)]}
            bad = {k: (res[k], lim) for k, lim in gates.items() if k in res and not res[k] <= lim}
            res["bf16"]["gates"] = bf16_gates(family, res)
            bad.update({f"bf16 {k}": (res["bf16"][k], lim) for k, lim in res["bf16"]["gates"].items()
                        if not res["bf16"][k] <= lim})
            if bad:
                out["failed"].append(f"{name}: against one rank's step over the global batch {bad}")
    with open(os.path.join(workdir, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    dist.barrier()
    dist.destroy_process_group()
    return 1 if out["failed"] else 0


def train_parallel_check(torch, device="cuda:0") -> dict:
    """[train_parallel]: TRAIN_PARALLEL_RUNS on two ranks sharing the card
    over gloo (NCCL refuses two ranks on one card), children of this script;
    the ranks end with the same parameters."""
    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_parallel_") as work:
        reports = run_ranks("train_parallel", work, TRAIN_PARALLEL_RANKS, TRAIN_PARALLEL_TIMEOUT, device)
    out = {"note": "two ranks share one card's SMs: these times are no speed-up figure"}
    per_rank = ("ms_per_step", "ms_steps", "f32_ms_steps", "collective_ms_per_step", "collective_mb_per_step",
                "collective_calls_per_step", "peak_mem_gib", "mfu", "fa_per_step", "fa_bwd_per_step", "s", "pass_s")
    for name in TRAIN_PARALLEL_RUNS:
        runs = [r["runs"][name] for r in reports]
        check(len({tuple(r["params_digest"]) for r in runs}) == 1,
              f"train_parallel {name}: the ranks' parameters differ: {[r['params_digest'] for r in runs]}")
        first = runs[0]
        out[name] = {k: first[k] for k in ("mesh", "form", "bf16_layers", "shape", "heads_per_rank", "losses",
                                           "f32_losses", "reference_f32_losses", "reference_f32_ms_steps", "loss_rel",
                                           "grad_max_rel", "grad_worst_leaf", "grad_rel", "param_max_abs_over_lr",
                                           "update_max_rel",
                                           "param_farthest_leaf", "params_over_0.2_lr", "f64", "bf16")}
        out[name]["per_rank"] = [{k: r[k] for k in per_rank} for r in runs]
    # the measured (bf16) passes' launches, every rank and flash run
    flash = [n for n, run in TRAIN_PARALLEL_RUNS.items() if run[3] == "flash"]
    out["launches"] = {k: sum(r["runs"][n]["launches"][k] for r in reports for n in flash) for k in ("FA", "FA-bwd")}
    out["launches_by_run"] = {n: {k: sum(r["runs"][n]["launches"][k] for r in reports) for k in ("FA", "FA-bwd")}
                              for n in flash}
    return out


# ----------------------------------------------------------------------
# the examples, the chunked impact probe, tests_tpu's properties
# ----------------------------------------------------------------------
EXAMPLES_CPU_THREADS, EXAMPLES_CPU_TIMEOUT = 2, 900
# [chunked_impact]: the small shape held card vs CPU (docs, vocabulary,
# postings per (term, chunk), docs per chunk, queries, query terms)
CHUNKED_SMALL = (100_000, 4_096, 16, 32_768, 8, 64)
# [tpu_tests]: tests_tpu/test_kernels_tpu.py's shapes (queries, corpus of
# the binned-vs-exact recall, depth)
TPU_TESTS_Q, TPU_TESTS_RECALL_DOCS, TPU_TESTS_K = 32, 1_048_576, 1000


def examples_cpu_main(workdir: str) -> int:
    """The three examples on the CPU (a child of this script, started
    before [train_parallel] so its host work overlaps the ranks' run):
    what each returned, and the scale example's PLAID index and IVF as
    built, to ``workdir/cpu.pt``."""
    import torch

    sys.path.insert(0, REPO)
    torch.set_num_threads(EXAMPLES_CPU_THREADS)
    from fusion_tpu_torch.examples import quickstart, scale_serving, streaming_serving

    out = {}
    t0 = time.perf_counter()
    out["quickstart"] = {**quickstart.main("cpu"), "s": time.perf_counter() - t0}
    t0 = time.perf_counter()
    scale = scale_serving.main("cpu")
    searcher = scale.pop("searcher")
    out["scale"] = {**scale, "colbert_index": searcher.colbert_index, "colbert_ivf": searcher.colbert_ivf,
                    "s": time.perf_counter() - t0}
    t0 = time.perf_counter()
    out["streaming"] = {**streaming_serving.main("cpu"), "s": time.perf_counter() - t0}
    torch.save(out, os.path.join(workdir, "cpu.pt"))
    return 0


def start_examples_cpu(workdir: str):
    """Start examples_cpu_main as a child of this script; stopped at exit
    if it is still running."""
    import atexit

    with open(os.path.join(workdir, "examples_cpu.log"), "w") as log:
        proc = subprocess.Popen([sys.executable, os.path.abspath(__file__), "--examples-cpu", workdir], stdout=log,
                                stderr=subprocess.STDOUT, cwd=REPO)

    def stop():
        if proc.poll() is None:
            proc.kill()
            proc.wait()

    atexit.register(stop)
    return proc


def lists_match(np, got, want, atol) -> bool:
    """Two RankedLists (the card's, the CPU's) equal up to ties within
    ``atol`` (same_up_to_ties on the host)."""
    return same_up_to_ties(np, got.ids.cpu().numpy(), got.scores.cpu().numpy(), want.ids.cpu().numpy(),
                           want.scores.cpu().numpy(), atol)


def examples_check(torch, np, proc, workdir, kernels, device="cuda") -> dict:
    """[examples]: fusion_tpu_torch/examples' three main() on the card, each
    with every launch count set to 0 just before and read just after, held
    to the same example on the CPU (the child started before
    [train_parallel]): quickstart's fused, BM25 candidate and reranked lists
    up to ties within F32_TIE, its metrics equal, K1 launched (its ColBERT
    leg); scale_serving over the CPU's PLAID index and IVF (the k-means of
    two devices may assign a near-equidistant token otherwise; the card's
    own build is compared with it and reported) with the persistence
    round-trip the example asserts, its fused and reloaded lists up to ties,
    K4 launched (PLAID's rescore); streaming_serving's four HTTP answers up
    to ties within 2e-6 (the server rounds to 6 decimals), /healthz equal."""
    from fusion_tpu_torch.examples import quickstart, scale_serving, streaming_serving
    from fusion_tpu_torch.serving import HybridSearcher

    t0 = time.perf_counter()
    try:
        proc.wait(timeout=EXAMPLES_CPU_TIMEOUT)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
    with open(os.path.join(workdir, "examples_cpu.log")) as f:
        log = f.read()
    check(proc.returncode == 0, f"examples: the CPU run exited {proc.returncode}\n{log[-4000:]}")
    cpu = torch.load(os.path.join(workdir, "cpu.pt"), weights_only=False)
    out: dict = {"cpu_wait_s": time.perf_counter() - t0, "cpu_s": {k: v["s"] for k, v in cpu.items()}}

    reset_counts(*kernels)
    t0 = time.perf_counter()
    got = quickstart.main(device)
    out["quickstart"] = {"s": time.perf_counter() - t0, "launches": counts(*kernels),
                         "ms_per_query": got["ms_per_query"], "metrics": got["shown"],
                         "fused_recall@5": got["fused_recall@5"]}
    want = cpu["quickstart"]
    check(out["quickstart"]["launches"]["K1"] > 0, "examples quickstart: K1 never launched (its ColBERT leg)")
    for name in ("fused", "candidates", "reranked"):
        check(lists_match(np, got[name], want[name], F32_TIE),
              f"examples quickstart: the card's {name} lists differ from the CPU's beyond ties")
    check(all(abs(got["metrics"][m] - v) <= 1e-9 for m, v in want["metrics"].items())
          and got["fused_recall@5"] == want["fused_recall@5"],
          f"examples quickstart: metrics {got['shown']} vs the CPU's {want['shown']}")

    real_build = HybridSearcher.build.__func__
    own = {}

    def build_on_cpu_plaid(cls, *a, **kw):
        searcher = real_build(cls, *a, **kw)
        own["index"], own["ivf"] = searcher.colbert_index, searcher.colbert_ivf
        searcher.colbert_index = cpu["scale"]["colbert_index"].to(searcher.device)
        searcher.colbert_ivf = cpu["scale"]["colbert_ivf"].to(searcher.device)
        return searcher

    HybridSearcher.build = classmethod(build_on_cpu_plaid)
    reset_counts(*kernels)
    t0 = time.perf_counter()
    try:
        got = scale_serving.main(device)
    finally:
        HybridSearcher.build = classmethod(real_build)
    want = cpu["scale"]
    cents, cpu_cents = own["index"].centroids.float().cpu(), want["colbert_index"].centroids.float()
    out["scale"] = {"s": time.perf_counter() - t0, "launches": counts(*kernels), "ms_per_query": got["ms_per_query"],
                    "own_build_centroid_max_diff_vs_cpu": float((cents - cpu_cents).abs().max()),
                    "own_build_ivf_equal_cpu": bool(torch.equal(own["ivf"].ivf_doc.cpu(),
                                                                want["colbert_ivf"].ivf_doc))}
    check(out["scale"]["launches"]["K4"] > 0, "examples scale_serving: K4 never launched (PLAID's rescore)")
    check(got["systems"] == want["systems"] and got["bm25_impact_shape"] == want["bm25_impact_shape"]
          and got["ivf_shape"] == want["ivf_shape"], f"examples scale_serving: {got['systems']} vs {want['systems']}")
    for name in ("ranked", "reloaded"):
        check(lists_match(np, got[name], want[name], F32_TIE),
              f"examples scale_serving: the card's {name} lists differ from the CPU's beyond ties")
    del got

    reset_counts(*kernels)
    t0 = time.perf_counter()
    got = streaming_serving.main(device)
    want = cpu["streaming"]
    out["streaming"] = {"s": time.perf_counter() - t0, "launches": counts(*kernels), "answers": got["answers"],
                        "stats": {k: got["stats"][k] for k in ("requests", "batches")}}
    for step, answer in got["answers"].items():
        w = want["answers"][step]
        check(same_up_to_ties(np, np.array([answer["ids"]]), np.array([answer["scores"]]), np.array([w["ids"]]),
                              np.array([w["scores"]]), 2e-6),
              f"examples streaming_serving {step}: {answer} vs the CPU's {w}")
    check(got["healthz"] == want["healthz"], f"examples streaming_serving: /healthz {got['healthz']}")
    check(got["stats"]["requests"] == want["stats"]["requests"], f"examples streaming_serving: {got['stats']}")
    gc.collect()
    torch.cuda.empty_cache()
    return out


def chunked_impact_check(torch, np, device="cuda", **probe_kw) -> tuple[dict, dict]:
    """[chunked_impact]: tools/probe_chunked_impact.py at its defaults
    (mMARCO's shape: 8,912,896 docs, V 32,768, 272 chunks x cap 64, B 64),
    each stage's ms; then chunked_impact_search at CHUNKED_SMALL on the card
    against its CPU run over the same postings (CPU-seeded, every odd term's
    last quarter padded, random query weights), both sort forms: ids equal
    up to ties and scores within 1e-5 of the row's largest.  Returns (the
    probe's record, the phase's fields)."""
    from fusion_tpu_torch.index.inverted import chunked_impact_search
    from fusion_tpu_torch.tools import probe_chunked_impact as probe

    torch.cuda.reset_peak_memory_stats()
    record = probe.run(device=device, **probe_kw)
    out = {"peak_gib": torch.cuda.max_memory_allocated() / 2**30}
    gc.collect()
    torch.cuda.empty_cache()
    n, v, capc, dpc, b, kq = CHUNKED_SMALL
    gen = torch.Generator().manual_seed(41)
    small = probe.make_index(n, v, capc, dpc, gen, "cpu")
    small.post_doc[1::2, :, -capc // 4:] = -1  # the uint16 pad 0xFFFF
    small.post_impact[1::2, :, -capc // 4:] = 0.0
    qt, _ = probe.make_queries(b, kq, v, gen, "cpu")
    qw = torch.rand(b, kq, generator=gen) * 1.3 + 0.2
    card = small._replace(post_doc=small.post_doc.to(device), post_impact=small.post_impact.to(device))
    for packed in (False, True):
        want = chunked_impact_search(qt, qw, small, k=1000, local_k=128, packed_sort=packed)
        got = chunked_impact_search(qt.to(device), qw.to(device), card, k=1000, local_k=128, packed_sort=packed)
        w, fin = want.scores.numpy(), np.isfinite(want.scores.numpy())
        tol = 1e-5 * float(np.abs(w[fin]).max())
        label = "packed" if packed else "sort2"
        out[f"small_{label}_max_score_diff"] = float(np.abs(got.scores.cpu().numpy()[fin] - w[fin]).max())
        check(lists_match(np, got, want, tol),
              f"chunked_impact: the {label} search on the card differs from the CPU's beyond ties within {tol}")
    return record, out


def tpu_tests_check(torch, np, kernels, device="cuda", recall_docs=TPU_TESTS_RECALL_DOCS) -> dict:
    """[tpu_tests]: the properties of tests_tpu/test_kernels_tpu.py that no
    other phase holds, at its shapes and tolerances: the blockwise top-k
    merge equal to one top-k of the whole matrix (ids equal, scores rtol
    1e-6); K2's binned top-1,000 against the exact int8 search at 1,048,576
    docs (mean overlap >= 0.97); K2's dead rows (scale 0) losing to real
    rows of negative similarity, ids and scores equal to the plain version;
    a 2-layer, hidden-256 bf16 encoder in the flash form (FA) against the
    einsum form on real positions (atol 0.15, rtol 0.05, least cosine >
    0.995); PLAID's rescore, gather and factored, through K4 against the
    plain gather (ids equal, scores rtol 1e-5, atol 1e-6)."""
    from fusion_tpu_torch.core.ranked import ranked_from_scores
    from fusion_tpu_torch.index.compression import compress_token_index
    from fusion_tpu_torch.index.dense_quant import quantize_dense_index, quantized_dense_search
    from fusion_tpu_torch.index.plaid import build_ivf, plaid_search
    from fusion_tpu_torch.models.encoder import Encoder, EncoderConfig, init_weights, place, token_tensors
    from fusion_tpu_torch.ops.attention import masked_attention_cuda
    from fusion_tpu_torch.ops.dense_topk import fused_dense_topk
    from fusion_tpu_torch.ops.topk import blockwise_topk

    out: dict = {}
    q, n, k, block = TPU_TESTS_Q, 8192, TPU_TESTS_K, 1024
    gen = torch.Generator(device=device).manual_seed(3)
    scores = torch.randn(q, n, device=device, generator=gen)

    def block_scores(bi):
        ids = bi * block + torch.arange(block, device=device, dtype=torch.int32)
        return scores[:, bi * block:(bi + 1) * block], ids.expand(q, block)

    got, want = blockwise_topk(block_scores, n // block, q, k), ranked_from_scores(scores, k)
    check(torch.equal(got.ids, want.ids) and torch.allclose(got.scores, want.scores, rtol=1e-6, atol=0.0),
          "tpu_tests blockwise_topk: the merged top-k differs from the one-shot top-k")
    out["blockwise_topk_exact"] = True

    # K2 against the exact int8 search at corpus scale (the corpus made on
    # the card; bin collisions lose ~ k^2 / (2 * bins) docs a query)
    gen = torch.Generator(device=device).manual_seed(6)
    corpus = torch.randn(recall_docs, 768, device=device, generator=gen)
    index = quantize_dense_index(corpus, similarity="cos_sim")
    del corpus
    queries = torch.randn(q, 768, device=device, generator=gen)
    reset_counts(*kernels)
    got = fused_dense_topk(queries, index, k=k)
    k2 = counts(*kernels)["K2"]
    exact = quantized_dense_search(queries, index, k=k)
    g_ids, w_ids = got.ids.cpu().numpy(), exact.ids.cpu().numpy()
    overlaps = [len(set(g_ids[i].tolist()) & set(w_ids[i].tolist())) / k for i in range(q)]
    out["fused_dense_vs_exact"] = {"docs": recall_docs, "mean_overlap": float(np.mean(overlaps)),
                                   "min_overlap": float(np.min(overlaps)), "K2": k2}
    check(k2 > 0 and out["fused_dense_vs_exact"]["mean_overlap"] >= 0.97,
          f"tpu_tests fused_dense_topk vs exact: {out['fused_dense_vs_exact']}")
    del index, got, exact
    gc.collect()
    torch.cuda.empty_cache()

    # dead rows: one real doc per 2,048-row block, the query anti-aligned
    blk, nblocks, h = 2048, 8, 128
    real_rows = np.arange(nblocks) * blk
    vals = torch.zeros(blk * nblocks, h, dtype=torch.int8)
    vals[real_rows, 0] = torch.arange(1, nblocks + 1, dtype=torch.int8)
    scales = torch.zeros(blk * nblocks)
    scales[real_rows] = 1.0 / 127
    qd = torch.zeros(4, h)
    qd[:, 0] = -1.0
    dead = (vals.to(device), scales.to(device), False)
    reset_counts(*kernels)
    got = fused_dense_topk(qd.to(device), dead, k=nblocks, doc_block=blk)
    k2 = counts(*kernels)["K2"]
    with plain_kernels():
        want = fused_dense_topk(qd.to(device), dead, k=nblocks, doc_block=blk)
    g_ids, g_sc = got.ids.cpu().numpy(), got.scores.cpu().numpy()
    fin = np.isfinite(g_sc)
    check(k2 > 0 and np.array_equal(g_ids, want.ids.cpu().numpy())
          and np.allclose(g_sc, want.scores.cpu().numpy(), rtol=1e-6, atol=1e-7, equal_nan=False)
          and all(set(g_ids[i][fin[i]].tolist()) == set(real_rows.tolist()) for i in range(4))
          and bool((g_sc[fin] < 0).all()) and bool((g_ids[~fin] == -1).all()),
          f"tpu_tests dead rows: ids {g_ids} scores {g_sc}")
    out["dense_dead_rows"] = {"K2": k2}

    # the flash form against einsum: the same weights, bf16, a padded batch
    kw = dict(vocab_size=1024, hidden_size=256, num_layers=2, num_heads=4, intermediate_size=512, dropout=0.0,
              dtype=torch.bfloat16)
    forms = {}
    for impl in ("einsum", "flash"):
        module = Encoder(EncoderConfig(attention_impl=impl, **kw))
        init_weights(module, 12)
        forms[impl] = place(module, torch.bfloat16, device)
    rng = np.random.default_rng(12)
    b, length = 8, 128
    lens = rng.integers(16, length + 1, size=b)
    mask_np = (np.arange(length)[None] < lens[:, None]).astype(np.int32)
    ids, mask = token_tensors(rng.integers(5, 1000, size=(b, length)), mask_np, device)
    with torch.no_grad():
        he = forms["einsum"](ids, mask).float()
        before = masked_attention_cuda.launches
        hf = forms["flash"](ids, mask).float()
        fa = masked_attention_cuda.launches - before
    m = mask[..., None].float()
    a, c = (he * m).reshape(-1, 256), (hf * m).reshape(-1, 256)
    keep = a.norm(dim=1) > 0
    cos = (a[keep] * c[keep]).sum(1) / (a[keep].norm(dim=1) * c[keep].norm(dim=1) + 1e-9)
    out["flash_encoder_parity"] = {"max_abs_diff": float((a - c).abs().max()), "min_cos": float(cos.min()), "FA": fa}
    check(fa > 0 and torch.allclose(he * m, hf * m, atol=0.15, rtol=0.05) and float(cos.min()) > 0.995,
          f"tpu_tests flash encoder parity: {out['flash_encoder_parity']}")
    del forms

    # PLAID's rescore through K4 against the plain gather, both forms
    rng = np.random.default_rng(6)
    n, ld, d = 2048, 16, 64
    toks = rng.standard_normal((n, ld, d), dtype=np.float32)
    toks /= np.linalg.norm(toks, axis=-1, keepdims=True)
    tmask = (rng.random((n, ld)) > 0.2).astype(np.float32)
    tmask[:, 0] = 1.0
    index = compress_token_index(torch.from_numpy(toks).to(device), torch.from_numpy(tmask).to(device),
                                 num_centroids=128, nbits=2, seed=0)
    ivf = build_ivf(index.centroid_ids, index.mask, 128, cap=256)
    q_tok = rng.standard_normal((4, 8, d), dtype=np.float32)
    q_tok = torch.from_numpy(q_tok / np.linalg.norm(q_tok, axis=-1, keepdims=True)).to(device)
    q_mask = torch.ones(4, 8, device=device)
    for impl in ("gather", "factored"):
        kw = dict(k=64, nprobe=4, ncand=512, cand_chunk=256, ncand_rescore=256, rescore_impl=impl)
        reset_counts(*kernels)
        got = plaid_search(q_tok, q_mask, index, ivf, **kw)
        k4 = counts(*kernels)["K4"]
        with plain_kernels():
            want = plaid_search(q_tok, q_mask, index, ivf, **kw)
        out[f"plaid_rescore_{impl}"] = {"K4": k4,
                                        "max_score_diff": float((got.scores - want.scores).abs().nan_to_num().max())}
        check(k4 > 0 and torch.equal(got.ids, want.ids)
              and torch.allclose(got.scores, want.scores, rtol=1e-5, atol=1e-6),
              f"tpu_tests plaid rescore {impl}: through K4 vs the plain gather {out[f'plaid_rescore_{impl}']}")
    gc.collect()
    torch.cuda.empty_cache()
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true",
                    help="also trace one warm search of each searcher with torch.profiler")
    # one rank of [sharded]'s or [train_parallel]'s two-rank part (the script
    # starts them itself)
    ap.add_argument("--sharded-rank", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--train_parallel-rank", dest="train_parallel_rank", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--rank-dir", help=argparse.SUPPRESS)
    ap.add_argument("--rank-port", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--rank-device", default="cuda:0", help=argparse.SUPPRESS)
    # [examples]' CPU run (the script starts it itself)
    ap.add_argument("--examples-cpu", dest="examples_cpu", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.examples_cpu is not None:
        return examples_cpu_main(args.examples_cpu)
    if args.sharded_rank is not None:
        return sharded_rank_main(args.sharded_rank, args.rank_dir, args.rank_port, args.rank_device)
    if args.train_parallel_rank is not None:
        return train_parallel_rank_main(args.train_parallel_rank, args.rank_dir, args.rank_port, args.rank_device)

    import numpy as np
    import torch

    t0 = time.perf_counter()
    check(torch.cuda.is_available(), "no CUDA device: this script measures the card and has no CPU mode")
    check(
        os.path.isdir(os.path.join(REPO, "fusion_tpu_torch")),
        "run chip_smoke.py from the root of a checkout (fusion_tpu_torch/ not found)",
    )
    sys.path.insert(0, REPO)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    print(smi, flush=True)
    kind, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    phase("device", t0, kind=repr(kind), count=count, torch=torch.__version__, cuda=torch.version.cuda)

    from fusion_tpu_torch.ops import _kernels, dense_topk, gather_rows, maxsim, scatter_score
    from fusion_tpu_torch.tools import bench_maxsim, probe_dense, probe_scatter_kernel, probe_scatter_layout

    kernels = (maxsim, dense_topk, scatter_score, gather_rows)
    t0 = time.perf_counter()
    libs = _kernels.load_all(["maxsim", "dense_topk", "scatter_score", "gather_rows", "attention"])
    phase("build", t0, nvcc_s=[f"{lib.build_seconds:.3f}" for lib in libs])
    for lib in libs:
        print(lib.build_log.strip(), flush=True)

    # training, on an empty card (so each peak is the step's own)
    t0 = time.perf_counter()
    phase("train", t0, gpu=repr(smi), **train_check(torch, np))
    t0 = time.perf_counter()
    phase("train_einsum_bf16", t0, gpu=repr(smi),
          **train_check(torch, np, attention_impl="einsum_bf16", warmup=1, timed=1, traced=False))
    t0 = time.perf_counter()
    phase("train_agreement", t0, **train_agreement(torch, np))
    t0 = time.perf_counter()
    phase("train_fit", t0, **train_fit(torch, np))
    # this slice's path: training through the flash form's kernels
    t0 = time.perf_counter()
    attn_bwd = attention_bwd_check(torch, RUNS)
    phase("attention_bwd", t0, gpu=repr(smi), **attn_bwd)
    t0 = time.perf_counter()
    train_flash = train_flash_check(torch, np)
    phase("train_flash", t0, gpu=repr(smi), **train_flash)
    t0 = time.perf_counter()
    phase("train_agreement_flash", t0, **train_agreement(torch, np, attention_impl="flash"))
    with tempfile.TemporaryDirectory(prefix="chip_smoke_hf_") as root:
        t0 = time.perf_counter()
        phase("hf_train", t0, gpu=repr(smi), **hf_train_check(torch, np, root))
    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as root:
        t0 = time.perf_counter()
        phase("cli_train", t0, gpu=repr(smi), **cli_train_check(torch, np, root, kernels))
    # the examples' CPU run, a child process whose host work overlaps the
    # two ranks' run
    examples_work = tempfile.TemporaryDirectory(prefix="chip_smoke_examples_")
    examples_cpu = start_examples_cpu(examples_work.name)
    # data- and tensor-parallel training: two ranks sharing the card
    t0 = time.perf_counter()
    train_parallel = train_parallel_check(torch)
    phase("train_parallel", t0, gpu=repr(smi), **train_parallel)

    # this slice's paths: the examples (K1 in quickstart, K4 in
    # scale_serving), tests_tpu's properties, the chunked impact probe
    t0 = time.perf_counter()
    examples = examples_check(torch, np, examples_cpu, examples_work.name, kernels)
    examples_work.cleanup()
    phase("examples", t0, gpu=repr(smi), **examples)
    t0 = time.perf_counter()
    tpu_tests = tpu_tests_check(torch, np, kernels)
    phase("tpu_tests", t0, gpu=repr(smi), **tpu_tests)
    t0 = time.perf_counter()
    chunked_record, chunked = chunked_impact_check(torch, np)
    print(json.dumps(chunked_record), flush=True)
    phase("chunked_impact", t0, gpu=repr(smi), **chunked,
          **{k: v for k, v in chunked_record["detail"].items() if k.endswith("_ms")})
    gc.collect()
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    ql = BATCH * LQ
    k1_work = (2.0 * ql * 28_032 * LD * DIM, 2 * (LD * 28_032 * DIM + ql * DIM) + 4 * 28_032 * ql)
    k1_bound = bench_maxsim.bound(*k1_work)
    k1_err, k1_ms, k1_plain = kernel_vs_plain(torch, maxsim, LD, 28_032, DIM, ql, seed=0, runs=RUNS)
    phase("kernel", t0, shape="Ld128xN28032xD128xQL2048", max_abs_err=k1_err, kernel_ms=k1_ms, plain_ms=k1_plain,
          bit_identical_launches=REPEATS + 1, bound_ms=k1_bound[0], **rates(*k1_work, k1_ms, k1_bound[0]))
    # a ragged shape; a doc slice of a larger corpus (start not a multiple
    # of the 64-doc tile, token stride 5,000 x D), as maxsim_search_tm
    # passes its doc blocks; and the other widths a card path runs (the
    # tiny searchers' D 16) or the kernel takes (D 96: not a multiple of 64)
    for ld, n, d, q_n, seed, doc_slice in ((37, 1000, DIM, 3 * 29, 1, None), (LD, 2000, DIM, 3 * 29, 2, (5000, 333)),
                                            (37, 1000, 16, 3 * 29, 3, None), (37, 1000, 96, 3 * 29, 4, None)):
        t0 = time.perf_counter()
        err, _, _ = kernel_vs_plain(torch, maxsim, ld, n, d, q_n, seed=seed, runs=0, doc_slice=doc_slice)
        phase("kernel", t0, shape=f"Ld{ld}xN{n}xD{d}xQL{q_n}" + (f" docs [{doc_slice[1]}, {doc_slice[1] + n}) of "
              f"{doc_slice[0]}" if doc_slice else ""), max_abs_err=err)
        k1_err = max(k1_err, err)

    # the rest of the MaxSim family at the headline bench shape (Q 32, Lq 32)
    # and ragged ones: Lq 13 and 48 (no whole number of queries fills a
    # consumer's 128 rows), Lq 128 (one query per consumer), Q 9 (a last
    # block with one query), D 96, N 1,001 with its first and last docs fully
    # masked (the mask's rows padded to 1,004 words); N 1000 and Ld 131 / 37
    # match no tile either
    hq, hn = 32, 28_032
    t0 = time.perf_counter()
    k1v1_err, k1v1_ms, k1v1_plain, k1v1_dev, (flops, nbytes) = k1v1_check(
        torch, maxsim, hq, LQ, hn, LD, DIM, 20, RUNS
    )
    k1v1_bound = bench_maxsim.bound(flops, nbytes)
    phase("k1v1", t0, shape=f"Q{hq}xLq{LQ}xN{hn}xLd{LD}xD{DIM} strict mask", max_abs_err=k1v1_err,
          kernel_ms=k1v1_ms, plain_ms=k1v1_plain, device_ms=k1v1_dev, bound_ms=k1v1_bound,
          bit_identical_launches=REPEATS + 1, device_share_of_bound=k1v1_bound[0] / k1v1_dev,
          **rates(flops, nbytes, k1v1_ms, k1v1_bound[0]))
    for q_n, lq, n, ld, d, seed, dead_ends in ((5, 13, 1000, 131, DIM, 21, False), (7, 48, 1000, 37, DIM, 27, False),
                                                (3, 128, 1000, 37, DIM, 28, False), (9, LQ, 1000, 37, DIM, 29, False),
                                                (5, LQ, 1000, 37, 96, 30, False), (5, LQ, 1001, 37, DIM, 31, True)):
        t0 = time.perf_counter()
        err, _, _, _, _ = k1v1_check(torch, maxsim, q_n, lq, n, ld, d, seed, 0, dead_ends=dead_ends)
        phase("k1v1", t0, shape=f"Q{q_n}xLq{lq}xN{n}xLd{ld}xD{d} strict mask"
              + (" (docs 0 and N-1 fully masked)" if dead_ends else ""), max_abs_err=err)
        k1v1_err = max(k1v1_err, err)
    # the zeroed fused sum (P1's _kernel_fusedsum) at the headline shape,
    # bit-identical over REPEATS more launches, and at Lq 13 and 48
    t0 = time.perf_counter()
    err, zero_ms, zero_plain, zero_dev, (flops, nbytes) = k1v1_check(
        torch, maxsim, hq, LQ, hn, LD, DIM, 24, RUNS, strict=False
    )
    zero_bound = bench_maxsim.bound(flops, nbytes)
    phase("maxsim_fused_zeromask", t0, shape=f"Q{hq}xLq{LQ}xN{hn}xLd{LD}xD{DIM}", max_abs_err=err,
          kernel_ms=zero_ms, plain_ms=zero_plain, device_ms=zero_dev, bound_ms=zero_bound,
          bit_identical_launches=REPEATS + 1, device_share_of_bound=zero_bound[0] / zero_dev)
    k1v1_err = max(k1v1_err, err)
    for q_n, lq, n, ld, seed in ((5, 13, 1000, 131, 25), (7, 48, 1000, 37, 32)):
        t0 = time.perf_counter()
        err, _, _, _, _ = k1v1_check(torch, maxsim, q_n, lq, n, ld, DIM, seed, 0, strict=False)
        phase("maxsim_fused_zeromask", t0, shape=f"Q{q_n}xLq{lq}xN{n}xLd{ld}xD{DIM}", max_abs_err=err)
        k1v1_err = max(k1v1_err, err)
    t0 = time.perf_counter()
    k1v2_err, k1v2_bf16_err, k1v2_ms, k1v2_plain, (flops, nbytes) = k1v2_check(
        torch, maxsim, hq * LQ, hn, LD, DIM, 22, RUNS
    )
    k1v2_bound = bench_maxsim.bound(flops, nbytes)
    phase("k1v2", t0, shape=f"QL{hq * LQ}xN{hn}xLd{LD}xD{DIM}", max_abs_err_f32=k1v2_err,
          max_abs_err_bf16=k1v2_bf16_err, kernel_ms=k1v2_ms, plain_ms=k1v2_plain, bound_ms=k1v2_bound[0],
          bit_identical_launches=REPEATS + 1, **rates(flops, nbytes, k1v2_ms, k1v2_bound[0]))
    # Ld 131 with tchunk 2, 4, 8: the last ring stage reaches past Ld, where
    # TMA fills zero tokens that must not enter the max
    for tchunk in (1, 2, 4, 8):
        t0 = time.perf_counter()
        err, bf16_err, _, _, _ = k1v2_check(torch, maxsim, 65, 1000, 131, DIM, 23, 0, tchunk=tchunk)
        phase("k1v2", t0, shape=f"QL65xN1000xLd131xD128 tchunk {tchunk}", max_abs_err_f32=err,
              max_abs_err_bf16=bf16_err)
        k1v2_err = max(k1v2_err, err)
    gc.collect()
    torch.cuda.empty_cache()

    # the MaxSim bench: every variant of the family, at the bench's headline
    # shape and the serving batch (QL 2,048)
    variant_counts = {"K1-v1": 0, "K1-v2": 0}
    bench = []
    for q_n in (hq, BATCH):
        t0 = time.perf_counter()
        maxsim.maxsim_fused_cuda.launches = maxsim.maxsim_maxima_v2_cuda.launches = 0
        record = bench_maxsim.run(q=q_n, lq=LQ, n=hn, ld=LD, d=DIM, runs=RUNS, seed=26)
        variant_counts["K1-v1"] += maxsim.maxsim_fused_cuda.launches
        variant_counts["K1-v2"] += maxsim.maxsim_maxima_v2_cuda.launches
        bench.append(record)
        phase("maxsim_variants", t0, shape=record["shape"], fastest=record["fastest"],
              library_matmul_same_flops_ms=record["library_matmul_same_flops_ms"],
              variants=[(v["name"], round(v["ms"], 4), round(v["bound_ms"], 4), v["max_abs_err"],
                         v["launches"]) for v in record["variants"]])
        print(json.dumps({"maxsim_variants": record}), flush=True)
        for v in record["variants"]:
            check(v["within_bound"], f"maxsim_variants {v['name']} at {record['shape']}: err {v['max_abs_err']}")
            check(v["launches"] > 0, f"maxsim_variants {v['name']}: never launched")
        gc.collect()
        torch.cuda.empty_cache()

    t0 = time.perf_counter()
    k2_err, checked, k2_ms, k2_plain = k2_check(torch, dense_topk, BATCH, MM_DOCS, MM_DOCS, MM_H, 3, RUNS)
    k2_work = (2.0 * BATCH * MM_H * MM_DOCS, MM_DOCS * (MM_H + 4) + 2 * BATCH * MM_H + 4 * BATCH * MM_DOCS // 16)
    k2_bound = bench_maxsim.bound(*k2_work)
    phase("k2", t0, shape=f"Q64xH768xN{MM_DOCS}", max_abs_err=k2_err, offsets_checked=checked,
          kernel_ms=k2_ms, plain_ms=k2_plain, bit_identical_launches=REPEATS + 1, bound_ms=k2_bound[0],
          **rates(*k2_work, k2_ms, k2_bound[0]))
    # a ragged shape at the serving width, and the tiny scale-mode
    # searcher's H 32 (columns past H zero-filled by TMA)
    for h in (MM_H, 32):
        t0 = time.perf_counter()
        err, checked, _, _ = k2_check(torch, dense_topk, 37, 100_003, -(-100_003 // 2048) * 2048, h, 4, 0)
        phase("k2", t0, shape=f"Q37xH{h}xN100003(pad 100352)", max_abs_err=err, offsets_checked=checked)
        k2_err = max(k2_err, err)
    gc.collect()
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    k3_err, checked, k3_ms, k3_plain, k3_dev = k3_check(
        torch, scatter_score, 5, BATCH, 64, SPLADE_VOCAB, MM_DOCS // MM_DPC, MM_CAPC, MM_DPC, RUNS
    )
    # the postings this run reads: every real (non-pad) query term's row in
    # each chunk, 2-byte doc + 2-byte impact; one add per posting
    kq, n_chunks = 64, MM_DOCS // MM_DPC
    postings = (BATCH * kq - len(range(0, BATCH, 5)) * (kq // 4)) * n_chunks * MM_CAPC
    k3_bound = bench_maxsim.bound(postings, 4 * postings + 8 * BATCH * kq + 4 * BATCH * n_chunks * MM_DPC // 16,
                                  bench_maxsim.PEAK_F32_FLOPS)
    phase("k3", t0, shape="Q64xKq64xC544xcapc32xdpc16384", max_abs_err=k3_err,
          offsets_checked=checked, kernel_ms=k3_ms, plain_ms=k3_plain, device_ms=k3_dev, bound_ms=k3_bound,
          repeats_within_tol=REPEATS + 1, share_of_bound=k3_bound[0] / k3_ms,
          device_share_of_bound=k3_bound[0] / k3_dev)
    # ragged rows (sentinel pads, an empty last chunk, pad query terms); the
    # widest layout (Kq*capc = MAX_POSTING_WIDTH); and the scale_build
    # searcher's layout, capc 74, whose rows are not 16-byte aligned
    for seed, q_n, kq, vocab, n_chunks, capc, dpc, pad_rows, note in (
        (6, 5, 7, 50, 3, 16, 2048, True, " (padded rows, empty chunk)"),
        (7, 9, 64, 500, 6, scatter_score.MAX_POSTING_WIDTH // 64, 2048, False, " (Kq*capc = 8192)"),
        (8, 9, 64, 500, 14, 74, 2048, True, " (rows not 16-byte aligned)"),
    ):
        t0 = time.perf_counter()
        err, checked, _, _, _ = k3_check(torch, scatter_score, seed, q_n, kq, vocab, n_chunks, capc, dpc, 0,
                                         pad_rows=pad_rows)
        phase("k3", t0, shape=f"Q{q_n}xKq{kq}xC{n_chunks}xcapc{capc}xdpc{dpc}{note}", max_abs_err=err,
              offsets_checked=checked)
        k3_err = max(k3_err, err)
    gc.collect()
    torch.cuda.empty_cache()

    # P3: K2 without the dead-row term at doc_block 4096, on one synthesized
    # mMARCO-size corpus (K2 checked at 4096 and 8192 on the same rows), and
    # on a ragged shape with scale-0 rows and pad rows masked by n_docs
    t0 = time.perf_counter()
    mm_inputs = k2_inputs(torch, BATCH, MM_DOCS, MM_DOCS, MM_H, 31)
    p3_err, checked, p3_ms, p3_plain = k2_check(
        torch, dense_topk, BATCH, MM_DOCS, MM_DOCS, MM_H, 31, RUNS, doc_block=4096, dead_rows=False,
        inputs=mm_inputs,
    )
    phase("p3", t0, shape=f"Q64xH768xN{MM_DOCS} doc_block 4096 no dead-row term", max_abs_err=p3_err,
          offsets_checked=checked, kernel_ms=p3_ms, plain_ms=p3_plain, bound_ms=k2_bound)
    for db in (4096, 8192):
        t0 = time.perf_counter()
        err, checked, _, _ = k2_check(torch, dense_topk, BATCH, MM_DOCS, MM_DOCS, MM_H, 31, 0, doc_block=db,
                                      inputs=mm_inputs)
        phase("p3", t0, shape=f"K2 Q64xH768xN{MM_DOCS} doc_block {db}", max_abs_err=err, offsets_checked=checked)
        k2_err = max(k2_err, err)
    del mm_inputs
    for dead_rows in (False, True):
        t0 = time.perf_counter()
        err, checked, _, _ = k2_check(torch, dense_topk, 37, 100_003, -(-100_003 // 8192) * 8192, MM_H, 32, 0,
                                      dead_every=13, doc_block=4096, dead_rows=dead_rows)
        phase("p3", t0, shape=f"{'K2' if dead_rows else 'P3'} Q37xH768xN100003(pad 106496, every 13th row "
              "scale 0) doc_block 4096", max_abs_err=err, offsets_checked=checked)
        if dead_rows:
            k2_err = max(k2_err, err)
        else:
            p3_err = max(p3_err, err)
    gc.collect()
    torch.cuda.empty_cache()

    # P4 and P5: the pre-gathered scatter kernel in each layout at the probe
    # shape (V 32,768 as the probe scripts; REPEATS more launches each within
    # K3_TOL of the first), and at K3's three other shapes: ragged rows, the
    # widest layout (one chunk-major item of 8,192 postings, 49,152 bytes:
    # two ring slots) and capc 74 (term-major rows not 16-byte aligned)
    t0 = time.perf_counter()
    pg = pregathered_check(torch, scatter_score, 33, BATCH, 64, 32_768, MM_DOCS // MM_DPC, MM_CAPC, MM_DPC, RUNS)
    pg_bound = {lay: bench_maxsim.bound(*v[4], bench_maxsim.PEAK_F32_FLOPS) for lay, v in pg.items()}
    for lay, v in pg.items():
        phase("p5" if lay == "chunk_major" else "p4", t0, shape=f"Q64xKq64xC544xcapc32xdpc16384 {lay}",
              max_abs_err=v[0], offsets_checked=v[1], kernel_ms=v[2], plain_ms=v[3], device_ms=v[5],
              bound_ms=pg_bound[lay], repeats_within_tol=REPEATS + 1, share_of_bound=pg_bound[lay][0] / v[2],
              device_share_of_bound=pg_bound[lay][0] / v[5])
    pg_err = {lay: v[0] for lay, v in pg.items()}
    pg_times = {lay: (v[2], v[3]) for lay, v in pg.items()}
    del pg
    for seed, q_n, kq, vocab, n_chunks, capc, dpc, pad_rows, note in (
        (34, 5, 7, 50, 3, 16, 2048, True, " (padded rows, empty chunk)"),
        (35, 9, 64, 500, 6, scatter_score.MAX_POSTING_WIDTH // 64, 2048, False, " (Kq*capc = 8192)"),
        (36, 9, 64, 500, 14, 74, 2048, True, " (rows not 16-byte aligned)"),
    ):
        t0 = time.perf_counter()
        shape = pregathered_check(torch, scatter_score, seed, q_n, kq, vocab, n_chunks, capc, dpc, 0,
                                  pad_rows=pad_rows)
        for lay, v in shape.items():
            phase("p5" if lay == "chunk_major" else "p4", t0,
                  shape=f"Q{q_n}xKq{kq}xC{n_chunks}xcapc{capc}xdpc{dpc} {lay}{note}", max_abs_err=v[0],
                  offsets_checked=v[1])
            pg_err[lay] = max(pg_err[lay], v[0])
        del shape
    gc.collect()
    torch.cuda.empty_cache()

    # the probe tools: each one's path with every launch count set to 0 just
    # before and read just after
    probe_counts = {}
    for name, tool, needs in (
        ("probe_dense", probe_dense, ("K2", "P3")),
        ("probe_scatter_layout", probe_scatter_layout, ("K3", "P4")),
        ("probe_scatter_kernel", probe_scatter_kernel, ("K3", "P5")),
    ):
        t0 = time.perf_counter()
        reset_counts(*kernels)
        record = tool.run(runs=RUNS)
        probe_counts[name] = counts(*kernels)
        print(json.dumps(record), flush=True)
        phase(name, t0, launches=probe_counts[name])
        for k in needs:
            check(probe_counts[name][k] > 0, f"{name}: {k} never launched")
        detail = record["detail"]
        check(detail.get("nt_scores_match", True) and detail.get("pattern_equal", True)
              and detail.get("nt_top10_overlap", 1.0) >= 0.99, f"{name}: check failed: {detail}")
        gc.collect()
        torch.cuda.empty_cache()

    t0 = time.perf_counter()
    k4_err = k4_ragged(torch, gather_rows)
    phase("k4", t0, shape="Q5xK37 (int32x7, u8x3, f32x5, u8x4x32, bool rows; rows 0 and N-1)",
          byte_equal=True, max_abs_err=k4_err)

    t0 = time.perf_counter()
    phase("small", t0, max_sorted_score_diff=small_agreement(torch, np, scale=False))
    t0 = time.perf_counter()
    phase("scale_small", t0, max_sorted_score_diff=small_agreement(torch, np, scale=True))
    t0 = time.perf_counter()
    phase("plaid_small", t0, max_sorted_score_diff=plaid_small_agreement(torch, np))
    t0 = time.perf_counter()
    phase("rerank_small", t0, score_diff_and_ids_checked=rerank_small_agreement(torch, np))

    from fusion_tpu_torch.models.biencoder import BiEncoder
    from fusion_tpu_torch.models.colbert import ColBERT
    from fusion_tpu_torch.models.crossencoder import CrossEncoder
    from fusion_tpu_torch.models.encoder import EncoderConfig
    from fusion_tpu_torch.serving import HybridSearcher

    t0 = time.perf_counter()
    docs, queries = zipf_corpus(np, N_DOCS, N_QUERIES)
    cfg = EncoderConfig(dtype=torch.bfloat16, dropout=0.0)  # CamemBERT-base width
    kw = dict(max_query_length=LQ, max_doc_length=LD, device="cuda")
    dense = BiEncoder(cfg, head="dense", seed=11, **kw)
    splade = BiEncoder(cfg, head="splade", seed=12, **kw)
    colbert = ColBERT(cfg, dim=DIM, seed=13, **kw)
    ce = CrossEncoder(cfg, max_length=256, seed=14, device="cuda")
    phase("models", t0, layers=cfg.num_layers, hidden=cfg.hidden_size, vocab=cfg.vocab_size)
    check(cfg.vocab_size == SPLADE_VOCAB, "the SPLADE encoder's vocabulary is not CamemBERT's")

    t0 = time.perf_counter()
    # the slice with the monoBERT stage (packed, the default): the main
    # path, driven in [rerank]; the phases before it serve the slice without
    # the stage (rerank_depth 0)
    index_kw = dict(dense_model=dense, splade_model=splade, colbert_model=colbert, cross_encoder=ce,
                    rerank_depth=100, topk=TOPK, batch_size=256, fusion_method="rrf", device="cuda")
    reranked = HybridSearcher.build(dict(enumerate(docs)), bm25_docs=docs, **index_kw)
    torch.cuda.synchronize()
    searcher = dataclasses.replace(reranked, rerank_depth=0)
    phase("index", t0, systems=",".join(searcher.active_systems), docs=N_DOCS,
          rerank_systems=",".join(reranked.active_systems))

    reset_counts(*kernels)
    t0 = time.perf_counter()
    ranked, _ = searcher.search(queries, batch_size=BATCH)
    slice_counts = counts(*kernels)
    phase("search", t0, queries=N_QUERIES, launches=slice_counts)
    check(slice_counts["K1"] >= N_QUERIES // BATCH, f"MaxSim kernel launched {slice_counts['K1']} times")
    check_ranked(torch, np, ranked, N_QUERIES, TOPK, N_DOCS)

    t0 = time.perf_counter()
    overlap = colbert_leg_overlap(torch, np, maxsim, searcher, queries[:BATCH])
    phase("colbert_leg", t0, top100_overlap_kernel_vs_plain=overlap)
    check(overlap >= 0.99, f"ColBERT leg kernel vs plain top-100 overlap {overlap}")
    warm_timing(torch, searcher, queries, "slice", smi)
    if args.profile:
        profile_search(torch, searcher, queries, "slice")
    t0 = time.perf_counter()
    phase("retrievers", t0, **retrievers_check(torch, np, maxsim, searcher, docs, queries[:BATCH]))
    t0 = time.perf_counter()
    rerank = rerank_check(torch, np, reranked, queries, smi, kernels)
    phase("rerank", t0, gpu=repr(smi), **rerank)
    t0 = time.perf_counter()
    phase("rerank_packed_fa", t0, gpu=repr(smi), **packed_fa_check(torch, np))
    t0 = time.perf_counter()
    attn = attention_check(torch, reranked, queries, RUNS)
    phase("attention", t0, gpu=repr(smi), **attn)
    t0 = time.perf_counter()
    forms = rerank_forms_check(torch, np, reranked, queries)
    phase("rerank_forms", t0, gpu=repr(smi), **forms)
    t0 = time.perf_counter()
    phase("t5", t0, gpu=repr(smi), **t5_check(torch, np, reranked, queries))
    t0 = time.perf_counter()
    phase("query_encoders", t0, gpu=repr(smi), **encoder_forms_check(torch, np, searcher, queries))

    # the serving surface over the slice: checkpoints, the index directory,
    # the HTTP front door over the reloaded searcher, the CLI
    work = tempfile.TemporaryDirectory(prefix="chip_smoke_")
    t0 = time.perf_counter()
    ckpt, ckpt_paths = checkpoint_check(
        torch, np, {"dpr": dense, "splade": splade, "colbert": colbert, "monobert": ce}, queries, work.name
    )
    phase("checkpoint", t0, gpu=repr(smi), **ckpt)
    t0 = time.perf_counter()
    fresh = HybridSearcher(
        corpus_ids=np.array([]), dense_model=dense, splade_model=splade, colbert_model=colbert,
        cross_encoder=ce, rerank_depth=100, topk=TOPK, fusion_method="rrf", device="cuda",
    )
    part = HybridSearcher.build(dict(enumerate(docs[:PERSIST_DOCS])), bm25_docs=docs[:PERSIST_DOCS], **index_kw)
    build_s = time.perf_counter() - t0
    persisted, reloaded = persist_check(torch, np, "slice", part, fresh, queries, kernels)
    del part
    phase("persist", t0, searcher="slice", docs=PERSIST_DOCS, build_s=build_s, gpu=repr(smi), **persisted)
    check(persisted["launches"]["K1"] > 0, "persist slice: K1 never launched")
    t0 = time.perf_counter()
    served = server_check(torch, np, dataclasses.replace(reloaded, rerank_depth=0), queries)
    phase("server", t0, gpu=repr(smi), **served)
    del reloaded, fresh
    t0 = time.perf_counter()
    phase("cli", t0, gpu=repr(smi), **cli_check(torch, np, docs, queries, ckpt_paths, work.name, kernels))
    work.cleanup()

    # streaming updates over the slice: the segmented searcher against the
    # full one, served while it takes updates; the C++ posting builders; the
    # dataset loaders through the CLI
    t0 = time.perf_counter()
    seg_docs = docs[:SEG_DOCS]
    seg_full = HybridSearcher.build(dict(enumerate(seg_docs)), bm25_docs=seg_docs,
                                    **{**index_kw, "cross_encoder": None, "rerank_depth": 0})
    seg_full_s = time.perf_counter() - t0
    seg_out, seg = segmented_check(torch, np, seg_docs, queries, index_kw, seg_full, kernels)
    del seg_full
    phase("segmented", t0, gpu=repr(smi), docs=SEG_DOCS, full_build_s=seg_full_s, **seg_out)
    t0 = time.perf_counter()
    phase("segmented_server", t0, gpu=repr(smi), **segmented_server_check(torch, np, seg, queries))
    del seg
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    phase("native", t0, **native_check(np, docs))
    with tempfile.TemporaryDirectory(prefix="chip_smoke_datasets_") as root:
        t0 = time.perf_counter()
        phase("cli_datasets", t0, gpu=repr(smi), **cli_datasets_check(torch, np, docs, queries, root, kernels))
    t0 = time.perf_counter()
    phase("mmarco_reader", t0, **reader_check(np))

    # the quality and measurement tools: the LLeQA harness, the recall study,
    # the roofline sweep over the slice's corpus and encoders, the studies
    # (each with the process's peak host memory after it)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_lleqa_") as root:
        t0 = time.perf_counter()
        lleqa = lleqa_parity_check(torch, np, root, kernels)
        phase("lleqa_parity", t0, gpu=repr(smi), host_peak_rss_gib=host_rss_gib(), **lleqa)
    t0 = time.perf_counter()
    recall = recall_check(torch, kernels)
    phase("recall_study", t0, gpu=repr(smi), host_peak_rss_gib=host_rss_gib(), **recall)
    t0 = time.perf_counter()
    roofline = roofline_check(torch, np, docs, (dense, splade, colbert), kernels)
    phase("roofline", t0, gpu=repr(smi), host_peak_rss_gib=host_rss_gib(), **roofline)
    t0 = time.perf_counter()
    phase("studies", t0, gpu=repr(smi), **studies_check(torch, np), host_peak_rss_gib=host_rss_gib())

    bm25 = searcher.bm25
    # the slice's cross-encoder doc tokens, for [sharded]'s rerank
    ce_tokens = dict(ce_doc_tokens=reranked.ce_doc_tokens, ce_doc_mask=reranked.ce_doc_mask,
                     ce_doc_lens=reranked.ce_doc_lens)
    del searcher, reranked, ranked
    gc.collect()
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    scale = HybridSearcher.build(
        dict(enumerate(docs)), bm25_docs=docs, dense_model=dense, splade_model=splade,
        colbert_model=colbert, topk=TOPK, batch_size=256, fusion_method="rrf", device="cuda",
        scale_mode=True, int8_corpus=True, dense_impl="fused", splade_impl="scatter",
        impact_cap=1024,
    )
    torch.cuda.synchronize()
    sc_idx = scale.splade_scatter_index
    phase("scale_index", t0, systems=",".join(scale.active_systems), docs=N_DOCS,
          splade_layout=f"C{sc_idx.num_chunks}xcapc{sc_idx.cap_per_chunk}xdpc{sc_idx.docs_per_chunk}")
    reset_counts(*kernels)
    t0 = time.perf_counter()
    ranked, _ = scale.search(queries, batch_size=BATCH)
    build_counts = counts(*kernels)
    phase("scale_search", t0, queries=N_QUERIES, launches=build_counts)
    for name in ("K1", "K2", "K3"):
        check(build_counts[name] > 0, f"scale_build: {name} never launched during the search")
    check_ranked(torch, np, ranked, N_QUERIES, TOPK, N_DOCS)
    warm_timing(torch, scale, queries, "scale_build", smi)
    if args.profile:
        profile_search(torch, scale, queries, "scale_build")
    # the scale forms' save and load; the ColBERT token index, the form
    # [persist] slice saves and reloads (~85 s of f16 compression), is left out
    t0 = time.perf_counter()
    fresh = HybridSearcher(
        corpus_ids=np.array([]), dense_model=dense, splade_model=splade, dense_impl="fused", topk=TOPK,
        fusion_method="rrf", device="cuda",
    )
    persisted, reloaded = persist_check(torch, np, "scale_build", dataclasses.replace(scale, colbert_index=None),
                                        fresh, queries, kernels)
    phase("persist", t0, searcher="scale_build", gpu=repr(smi), **persisted)
    for name in ("K2", "K3"):
        check(persisted["launches"][name] > 0, f"persist scale_build: {name} never launched")
    del scale, ranked, fresh, reloaded
    gc.collect()
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    pb = HybridSearcher.build(
        dict(enumerate(docs)), bm25_docs=docs, dense_model=dense, splade_model=splade,
        colbert_model=colbert, topk=TOPK, batch_size=256, fusion_method="rrf", device="cuda",
        scale_mode=True, int8_corpus=True, dense_impl="fused", splade_impl="scatter",
        impact_cap=1024, colbert_compressed=True, colbert_plaid=True,
    )
    torch.cuda.synchronize()
    cb = pb.colbert_index
    phase("plaid_index", t0, systems=",".join(pb.active_systems), docs=N_DOCS,
          colbert_parts_s=pb.build_seconds, centroids=cb.centroids.shape[0],
          colbert_gb=(cb.nbytes() + cb.mask.nbytes + pb.colbert_ivf.nbytes()) / 1e9,
          build_peak_gib=torch.cuda.max_memory_allocated() / 2**30)
    reset_counts(*kernels)
    t0 = time.perf_counter()
    ranked, _ = pb.search(queries, batch_size=BATCH)
    plaid_counts = counts(*kernels)
    phase("plaid_search", t0, queries=N_QUERIES, launches=plaid_counts)
    for name in ("K2", "K3", "K4"):
        check(plaid_counts[name] > 0, f"plaid_build: {name} never launched during the search")
    check_ranked(torch, np, ranked, N_QUERIES, TOPK, N_DOCS)
    t0 = time.perf_counter()
    overlaps = compressed_overlaps(torch, np, maxsim, pb, queries[:BATCH])
    phase("plaid_colbert_leg", t0, top100_overlap=overlaps)
    check(overlaps["exhaustive_kernel_vs_plain"] >= 0.99,
          f"plaid_build: exhaustive compressed search kernel vs plain overlap {overlaps}")
    check(overlaps["colbert_search_compressed_vs_plain"] >= 0.99 and overlaps["colbert_search_compressed_K1"] > 0,
          f"retrievers: ColBERT.search over the compressed index vs plain {overlaps}")
    warm_timing(torch, pb, queries, "plaid_build", smi)
    if args.profile:
        profile_search(torch, pb, queries, "plaid_build")
    t0 = time.perf_counter()
    fresh = HybridSearcher(
        corpus_ids=np.array([]), dense_model=dense, splade_model=splade, colbert_model=colbert,
        dense_impl="fused", topk=TOPK, fusion_method="rrf", device="cuda",
    )
    persisted, reloaded = persist_check(torch, np, "plaid_build", pb, fresh, queries, kernels)
    phase("persist", t0, searcher="plaid_build", gpu=repr(smi), **persisted)
    for name in ("K2", "K3", "K4"):
        check(persisted["launches"][name] > 0, f"persist plaid_build: {name} never launched")
    del fresh, reloaded

    # the multi-device serving tier over the plaid_build searcher with the
    # packed rerank of the fused top 100 in the flash form
    t0 = time.perf_counter()
    src = dataclasses.replace(pb, cross_encoder=ce.with_attention("flash"), rerank_depth=100, rerank_packed=True,
                              **ce_tokens)
    sharded = sharded_check(torch, np, src, queries, kernels)
    sharded_server = sharded.pop("server")
    phase("sharded", t0, gpu=repr(smi), **sharded)
    phase("sharded_server", time.perf_counter() - sharded_server["s"], gpu=repr(smi), **sharded_server)
    sharded_launches = {**sharded["two_ranks"]["launches"], "K1": sharded["two_ranks"]["standalone"]["launches"]["K1"]}
    server_launches = {k: sum(r[k] for r in sharded_server["launches_per_rank"]) for k in sharded_launches}
    del src, pb, cb, ranked, ce_tokens
    gc.collect()
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    bm25_ii, dense_idx, scatter_idx, store, index_gb = synth_mmarco(torch, np, bm25)
    mm = HybridSearcher(
        corpus_ids=np.arange(MM_DOCS, dtype=np.int64), bm25=bm25, bm25_impact_index=bm25_ii,
        dense_model=dense, dense_corpus=dense_idx, dense_impl="fused",
        splade_model=splade, splade_scatter_index=scatter_idx, splade_query_terms=64,
        splade_rescore_store=store, splade_rescore_depth=MM_DEPTH,
        topk=TOPK, fusion_method="rrf", device=torch.device("cuda"),
    )
    torch.cuda.synchronize()
    phase("mmarco_index", t0, systems=",".join(mm.active_systems), docs=MM_DOCS, index_gb=index_gb,
          bm25_vocab=bm25.vocab_size, splade_vocab=SPLADE_VOCAB)
    reset_counts(*kernels)
    t0 = time.perf_counter()
    ranked, _ = mm.search(queries, batch_size=BATCH)
    mm_counts = counts(*kernels)
    phase("mmarco_search", t0, queries=N_QUERIES, launches=mm_counts)
    for name in ("K2", "K3"):
        check(mm_counts[name] > 0, f"scale_mmarco: {name} never launched during the search")
    check_ranked(torch, np, ranked, N_QUERIES, TOPK, MM_DOCS)
    t0 = time.perf_counter()
    legs = scale_legs_overlap(torch, np, mm, queries[:BATCH])
    phase("mmarco_legs", t0, top100_overlap_kernel_vs_plain=legs)
    for name, value in legs.items():
        check(value >= 0.99, f"scale_mmarco: {name} leg kernel vs plain top-100 overlap {value}")
    warm_timing(torch, mm, queries, "scale_mmarco", smi)
    if args.profile:
        profile_search(torch, mm, queries, "scale_mmarco")

    # ColBERT joins as the fourth leg: PLAID over the synthesized index
    t0 = time.perf_counter()
    cb_index, cb_ivf, cb_gb = synth_plaid(torch)
    torch.cuda.synchronize()
    phase("mmarco_plaid_index", t0, docs=MM_DOCS, colbert_gb=cb_gb, index_gb=index_gb + cb_gb,
          centroids=MM_C, ld=MM_LD, nbits=MM_NBITS, ivf_cap=MM_IVF_CAP)
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(9)
    idx = torch.randint(0, MM_DOCS, (BATCH, MM_CAND_CHUNK), device="cuda", generator=gen, dtype=torch.int32)
    idx[:, 0] = MM_DOCS - 1
    fresh = [torch.randint(0, MM_DOCS, idx.shape, device="cuda", generator=gen, dtype=torch.int32)
             for _ in range(RUNS - 1)]
    err, k4_times = k4_check(
        torch, gather_rows, (cb_index.centroid_ids, cb_index.codes, cb_index.mask), idx, RUNS, fresh
    )
    phase("k4", t0, shape=f"Q64xK512 over cid i32[{MM_DOCS},32], codes u8[{MM_DOCS},32,32], mask u8[{MM_DOCS},32]",
          byte_equal=True, max_abs_err=err, **k4_times)
    k4_ms, k4_plain = k4_times["kernel_device_ms"], k4_times["plain_device_ms"]
    row_bytes = MM_LD * (4 + DIM * MM_NBITS // 8 + 1)  # centroid ids, codes, mask of one doc
    k4_bound = bench_maxsim.bound(0.0, 2 * idx.numel() * row_bytes)
    k4_err = max(k4_err, err)
    mm.colbert_model, mm.colbert_index, mm.colbert_ivf = colbert, cb_index, cb_ivf
    reset_counts(*kernels)
    t0 = time.perf_counter()
    ranked, _ = mm.search(queries, batch_size=BATCH)
    mm4_counts = counts(*kernels)
    phase("mmarco4_search", t0, queries=N_QUERIES, systems=",".join(mm.active_systems), launches=mm4_counts)
    for name in ("K2", "K3", "K4"):
        check(mm4_counts[name] > 0, f"scale_mmarco four legs: {name} never launched during the search")
    check_ranked(torch, np, ranked, N_QUERIES, TOPK, MM_DOCS)
    t0 = time.perf_counter()
    legs = scale_legs_overlap(torch, np, mm, queries[:BATCH])
    legs["colbert"], colbert_diff = plaid_leg_vs_plain(torch, np, mm, queries[:BATCH])
    phase("mmarco4_legs", t0, top100_overlap_kernel_vs_plain=legs, colbert_max_score_diff=colbert_diff)
    for name, value in legs.items():
        check(value >= 0.99, f"scale_mmarco four legs: {name} leg kernel vs plain top-100 overlap {value}")
    t0 = time.perf_counter()
    phase("mmarco_plaid_breakdown", t0, **plaid_breakdown(torch, mm, queries[:BATCH]))
    warm_timing(torch, mm, queries, "scale_mmarco4", smi)
    if args.profile:
        profile_search(torch, mm, queries, "scale_mmarco4")

    def entry(name, source, replaces, launches, err, ms, plain_ms, bound, library_ms=None, **more):
        return {
            "name": name, "route": "cuda", "source": f"fusion_tpu_torch/csrc/{source}",
            "replaces": replaces, "launches": launches, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound[0], "bound_by": bound[1], "library_ms": library_ms, **more,
        }

    def attention_shape(res, kernels):
        """One shape of FA or FA-bwd for the kernels line: its times (device
        ms from queued calls; the trace's ms by kernel), bound and library
        call."""
        bound = res["bound_ms"] if isinstance(res["bound_ms"], tuple) else (res["bound_ms"], res["bound_by"])
        return {"shape": res["shape"], "ms": res["ms"], "plain_ms": res["plain_ms"], "device_ms": res["device_ms"],
                "traced_ms": {k: res["traced"].get(f"{k}_ms") for k in kernels}, "bound_ms": bound[0],
                "bound_by": bound[1], "library_ms": res["library_ms"], "library_device_ms": res["library_device_ms"]}

    record = {"kernels": [
        # K1's launches: the main path's run, the slice with the packed rerank;
        # and the segmented path's 192-query search over two segments
        entry("maxsim_maxima_T", "maxsim.cu", "fusion_tpu/ops/maxsim.py:225", rerank["launches"]["K1"],
              k1_err, k1_ms, k1_plain, k1_bound, segmented_launches=seg_out["search_launches"]["K1"],
              sharded_launches=sharded_launches["K1"], sharded_server_launches=server_launches["K1"],
              lleqa_parity_launches=lleqa["full_launches"]["K1"], recall_study_launches=recall["launches"]["K1"],
              roofline_launches=roofline["K1"], examples_launches=examples["quickstart"]["launches"]["K1"]),
        entry("dense_binmax", "dense_topk.cu", "fusion_tpu/ops/dense_topk.py:102", mm4_counts["K2"],
              k2_err, k2_ms, k2_plain, k2_bound, sharded_launches=sharded_launches["K2"],
              sharded_server_launches=server_launches["K2"], recall_study_launches=recall["launches"]["K2"],
              tpu_tests_launches=tpu_tests["fused_dense_vs_exact"]["K2"] + tpu_tests["dense_dead_rows"]["K2"]),
        entry("scatter_binmax", "scatter_score.cu", "fusion_tpu/ops/scatter_score.py:138",
              mm4_counts["K3"], k3_err, k3_ms, k3_plain, k3_bound, sharded_launches=sharded_launches["K3"],
              sharded_server_launches=server_launches["K3"], recall_study_launches=recall["launches"]["K3"]),
        # the library call of K4's function is index_select, its plain version
        entry("gather_rows", "gather_rows.cu", "fusion_tpu/ops/gather_rows.py:41", mm4_counts["K4"],
              k4_err, k4_ms, k4_plain, k4_bound, library_ms=k4_plain, sharded_launches=sharded_launches["K4"],
              sharded_server_launches=server_launches["K4"], recall_study_launches=recall["launches"]["K4"],
              examples_launches=examples["scale"]["launches"]["K4"],
              tpu_tests_launches=sum(tpu_tests[f"plaid_rescore_{f}"]["K4"] for f in ("gather", "factored"))),
        entry("maxsim_fused", "maxsim.cu",
              "fusion_tpu/ops/maxsim.py:67; scripts/bench_maxsim.py:55", variant_counts["K1-v1"],
              k1v1_err, k1v1_ms, k1v1_plain, k1v1_bound),
        entry("maxsim_maxima_v2", "maxsim.cu",
              "fusion_tpu/ops/maxsim.py:148; scripts/bench_maxsim.py:26,37,239; "
              "scripts/bench_maxsim2.py:15,25,34", variant_counts["K1-v2"],
              k1v2_err, k1v2_ms, k1v2_plain, k1v2_bound),
        entry("dense_binmax_nomask", "dense_topk.cu", "scripts/probe_dense.py:106",
              probe_counts["probe_dense"]["P3"], p3_err, p3_ms, p3_plain, k2_bound),
        entry("scatter_pregathered_term_major", "scatter_score.cu", "scripts/probe_scatter_layout.py:159",
              probe_counts["probe_scatter_layout"]["P4"], pg_err["term_major"], *pg_times["term_major"],
              pg_bound["term_major"]),
        entry("scatter_pregathered_chunk_major", "scatter_score.cu", "scripts/probe_scatter_kernel.py:37",
              probe_counts["probe_scatter_kernel"]["P5"], pg_err["chunk_major"], *pg_times["chunk_major"],
              pg_bound["chunk_major"]),
        # FA: launches in the main path's packed search ([rerank]; the
        # packed rows of the default einsum form, and the flash form's path),
        # times at the main path's packed shape, the library call
        # scaled_dot_product_attention (memory-efficient)
        entry("masked_attention", "attention.cu",
              "fusion_tpu/models/encoder.py:225 (jax.experimental.pallas.ops.tpu.flash_attention, "
              "forward pallas_call at flash_attention.py:758)",
              rerank["launches"]["FA"], attn["max_abs_err"], attn["packed"]["ms"],
              attn["packed"]["plain_ms"], attn["packed"]["bound_ms"], library_ms=attn["packed"]["library_ms"],
              shapes={c: attention_shape(attn[c], ATTENTION_KERNELS[:1]) for c in ("packed", "bench_doc")},
              sharded_launches=sharded_launches["FA"], sharded_server_launches=server_launches["FA"],
              parallel_launches=train_parallel["launches"]["FA"],
              parallel_launches_by_run={n: v["FA"] for n, v in train_parallel["launches_by_run"].items()},
              tpu_tests_launches=tpu_tests["flash_encoder_parity"]["FA"]),
        # FA's backward (the D pass, dK/dV and dQ kernels): launches in
        # [train_flash]'s flash run (this slice's path), times at one layer's
        # doc call of that step, the library call scaled_dot_product_attention's
        # backward (memory-efficient)
        entry("attention_backward", "attention.cu",
              "jax flash_attention.py:1121 (dK, dV pallas_call), :1456 (dQ pallas_call), via "
              "_flash_attention_bwd :254-318 (fusion_tpu/models/encoder.py:225)",
              train_flash["flash"]["launches"]["FA-bwd"], attn_bwd["max_abs_err"], attn_bwd["bench_doc"]["ms"],
              attn_bwd["bench_doc"]["plain_ms"],
              (attn_bwd["bench_doc"]["bound_ms"], attn_bwd["bench_doc"]["bound_by"]),
              library_ms=attn_bwd["bench_doc"]["library_ms"],
              shapes={c: attention_shape(attn_bwd[c], ATTENTION_KERNELS[1:]) for c in ("bench_doc", "packed")},
              parallel_launches=train_parallel["launches"]["FA-bwd"],
              parallel_launches_by_run={n: v["FA-bwd"] for n, v in train_parallel["launches_by_run"].items()}),
    ]}
    print(json.dumps(record), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
