"""Training around the step, on the CPU at ``EncoderConfig.tiny``: the
decay mask and freeze labels through the converter against the JAX
package's, frozen parameters, dropout and remat (the recompute trap), the
host loop ``fit`` (step accounting with prefetch 0 and 2, iterator errors,
cycling a plain generator; mirroring ``tests/test_e2e_training.py``), a
save / restore of the train state that resumes bit for bit, and the
samplers and collation against the JAX package's.

Tolerances: the frozen-parameter run's trained leaves within 5e-5 of
JAX's (as ``test_torch_train.py``); remat on / off gradients within
rtol 1e-6 (the same masks, the recompute's sums in the same order up to
autograd's accumulation); everything else exact."""


import weakref

import numpy as np
import pytest
import torch
from torch_parity import DEVICE
from torch_train_parity import V, flat, jax_batch, models, pair_batch, tokens, triplet_batch

from fusion_tpu.data import datasets as jd
from fusion_tpu.data.lleqa import LLeQALoader as JaxLoader
from fusion_tpu.data.tokenization import TextEncoder as JaxTextEncoder
from fusion_tpu.data.tokenization import WordHashTokenizer as JaxTokenizer
from fusion_tpu.train import trainer as jt
from fusion_tpu.train.optim import _no_decay_mask
from fusion_tpu_torch.data import datasets as td
from fusion_tpu_torch.data.lleqa import LLeQALoader
from fusion_tpu_torch.data.tokenization import TextEncoder, WordHashTokenizer
from fusion_tpu_torch.models import convert
from fusion_tpu_torch.models.biencoder import BiEncoder
from fusion_tpu_torch.models.encoder import DropoutKey, EncoderConfig, token_tensors
from fusion_tpu_torch.train import trainer as tt
from fusion_tpu_torch.train.optim import no_decay_mask

FIT = dict(steps=10, learning_rate=1e-3, warmup_ratio=0.3)
PARAM_ATOL = 5e-5


@pytest.mark.parametrize("kind,head", [("biencoder", "dense"), ("biencoder", "splade"), ("colbert", None),
                                       ("crossencoder", None)])
def test_decay_mask_and_freeze_labels_match_jax(kind, head):
    jm, tm = models(kind, head or "dense")
    layouts = convert.flax_layouts(tm.module, tm.cfg.num_heads)
    paths = [lay.path for lay in layouts.values()]
    jparams = jm.params["params"] if "params" in jm.params else jm.params
    assert sorted(paths) == sorted(flat(jparams))
    want_mask = flat(_no_decay_mask(jparams))
    assert {p: bool(v) for p, v in no_decay_mask(paths).items()} == {p: bool(v) for p, v in want_mask.items()}
    for n_top in (0, 1, 2):
        want = flat(jt.freeze_labels(jparams, n_top))
        assert tt.freeze_labels(paths, n_top) == {p: str(v) for p, v in want.items()}


def test_frozen_params_neither_move_nor_clip():
    """With the bottom layer frozen, the embeddings and layer_0 keep their
    values and the trained leaves match JAX's multi_transform (whose clip
    norm covers the trainable leaves only)."""
    jm, tm = models("biencoder", "dense")
    cfg = dict(FIT, freeze_layers_except_last_n=1, max_grad_norm=0.01)
    rank = {"name": "MNRLoss", "scale": 20.0}
    p0 = {k: v.copy() for k, v in flat(tm.flax_tree(tm.module.state_dict())).items()}
    jstate, jtx, _ = jt.init_train_state(jm, jt.FitConfig(**cfg))
    tstate, ttx, _ = tt.init_train_state(tm, tt.FitConfig(**cfg))
    jstep, tstep = jt.make_biencoder_train_step(jm, jtx, rank, None, 10), tt.make_biencoder_train_step(tm, ttx, rank, None, 10)
    batch = triplet_batch()
    for _ in range(3):
        jstate, _ = jstep(jstate, jax_batch(batch))
        tstate, _ = tstep(tstate, tt._to_device(batch, tm.device))
    got, want = flat(tm.flax_tree(tm.module.state_dict())), flat(jstate.params)
    for k in want:
        frozen = k[0] == "embeddings" or k[0] == "layer_0"
        assert np.array_equal(got[k], p0[k]) == frozen, k
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=PARAM_ATOL, err_msg=str(k))


def test_training_needs_f32_master_weights():
    tm = BiEncoder(EncoderConfig.tiny(vocab_size=V, dtype=torch.bfloat16), device=DEVICE)
    with pytest.raises(ValueError, match="param_dtype=torch.float32"):
        tt.init_train_state(tm, tt.FitConfig(**FIT))


def test_train_mode_at_dropout_0_equals_the_eval_forward():
    _, tm = models("biencoder", "splade")
    ids, mask = tokens(np.random.default_rng(3), 5, 10)
    t = token_tensors(ids, mask, DEVICE)
    tm.pruning_topk = None
    want = tm.embed_tokens(*t)
    got = tm.embed_tokens_train(*t, DropoutKey(7, 3))
    assert torch.equal(got.detach(), want)


def _dropout_loss(model, batch, step, seed=5):
    return tt.biencoder_loss(model, tt._to_device(batch, model.device), step, {"name": "MNRLoss"}, None, 10, seed)[0]


def test_dropout_masks_follow_seed_and_step():
    _, tm = models("biencoder", "dense", dropout=0.1)
    batch = triplet_batch()
    a, b = _dropout_loss(tm, batch, 3), _dropout_loss(tm, batch, 3)
    assert float(a) == float(b)
    assert float(_dropout_loss(tm, batch, 4)) != float(a)
    assert float(_dropout_loss(tm, batch, 3, seed=6)) != float(a)
    with torch.no_grad():
        assert float(_dropout_loss(tm, batch, 3)) == float(a)


@pytest.mark.parametrize("kind", ["dense", "colbert", "crossencoder"])
def test_remat_recompute_draws_the_same_masks(kind):
    """Dropout 0.1, remat on and off: the same loss and gradients (the
    recompute reseeds each site's generator)."""
    out = []
    for remat in (False, True):
        if kind == "dense":
            _, tm = models("biencoder", "dense", dropout=0.1, remat=remat)
            loss = _dropout_loss(tm, triplet_batch(), 2)
        elif kind == "colbert":
            _, tm = models("colbert", dropout=0.1, remat=remat)
            loss = tt.colbert_loss(tm, tt._to_device(triplet_batch(float_masks=True), tm.device), 2, seed=5)[0]
        else:
            _, tm = models("crossencoder", dropout=0.1, remat=remat)
            loss = tt.crossencoder_loss(tm, tt._to_device(pair_batch(), tm.device), 2, seed=5)[0]
        loss.backward()
        out.append((float(loss), {n: p.grad.clone() for n, p in tm.module.named_parameters()}))
    (l0, g0), (l1, g1) = out
    assert l0 == l1
    for n in g0:
        torch.testing.assert_close(g1[n], g0[n], rtol=1e-6, atol=1e-9)


# ----------------------------------------------------------------------
# fit
# ----------------------------------------------------------------------
class _CountingIterable:
    """Re-iterable batch source counting its passes; ``fail_at`` raises."""

    def __init__(self, n_batches, fail_at=None):
        self.n, self.fail_at, self.epochs = n_batches, fail_at, 0

    def __iter__(self):
        self.epochs += 1
        for i in range(self.n):
            if self.fail_at is not None and i == self.fail_at:
                raise RuntimeError("boom in data iterator")
            yield {"loss_in": np.array(float(i + 1 + self.n * (self.epochs - 1)))}


class _NullModel:
    device = torch.device("cpu")


def _identity_step(state, batch):
    return tt.TrainState(state.params, state.opt_state, state.step + 1, state.seed), {"loss": batch["loss_in"]}


@pytest.mark.parametrize("prefetch", [0, 2])
def test_fit_step_accounting_and_prefetch(prefetch):
    logged = []
    cfg = tt.FitConfig(steps=7, log_every_n_steps=1, prefetch=prefetch,
                       log_callback=lambda ep, spe, step, lr, value, name: logged.append((step, name, value)))
    data = _CountingIterable(n_batches=3)  # cycles: 3 < 7 steps
    out = tt.fit(_NullModel(), _identity_step, data, cfg, state=tt.TrainState({}, (), 100))
    assert out.step == 107
    assert [s for s, name, _ in logged if name == "loss"] == [101, 102, 103, 104, 105, 106, 107]
    assert [v for _, name, v in logged if name == "loss"] == [1.0, 2.0, 3.0, 4.0, 5.0, 6.0, 7.0]
    assert data.epochs >= 3
    assert [name for _, name, _ in logged][-1] == "sec_per_step"


def test_fit_prefetch_propagates_iterator_errors():
    with pytest.raises(RuntimeError, match="boom in data iterator"):
        tt.fit(_NullModel(), _identity_step, _CountingIterable(5, fail_at=2), tt.FitConfig(steps=5, prefetch=2),
               state=tt.TrainState({}, (), 0))


def test_fit_cycles_a_plain_generator():
    logged = []
    cfg = tt.FitConfig(steps=7, log_every_n_steps=1, prefetch=2,
                       log_callback=lambda ep, spe, step, lr, value, name: logged.append(value) if name == "loss" else None)

    def gen():
        for i in range(3):
            yield {"loss_in": np.array(float(i + 1))}

    assert tt.fit(_NullModel(), _identity_step, gen(), cfg, state=tt.TrainState({}, (), 0)).step == 7
    assert logged == [1.0, 2.0, 3.0, 1.0, 2.0, 3.0, 1.0]


@pytest.mark.parametrize("prefetch", [0, 2])
def test_fit_over_an_endless_generator_keeps_a_bounded_cache(monkeypatch, prefetch):
    """A plain generator that never ends is not cached past
    MAX_CACHED_BATCHES: the batches alive at each draw stay bounded."""
    monkeypatch.setattr(tt, "MAX_CACHED_BATCHES", 8)
    refs, alive, logged = [], [], []

    def endless():
        i = 0
        while True:
            alive.append(sum(r() is not None for r in refs))
            i += 1
            a = np.array(float(i))
            refs.append(weakref.ref(a))
            yield {"loss_in": a}

    cfg = tt.FitConfig(steps=40, log_every_n_steps=1, prefetch=prefetch,
                       log_callback=lambda ep, spe, step, lr, value, name: logged.append(value) if name == "loss" else None)
    assert tt.fit(_NullModel(), _identity_step, endless(), cfg, state=tt.TrainState({}, (), 0)).step == 40
    assert logged == [float(i) for i in range(1, 41)]
    assert max(alive) <= 8 + 1 + prefetch + 2  # the cache, the draw that overflowed it, the queue, in flight


def test_fit_refuses_to_cycle_a_plain_iterator_longer_than_its_cache(monkeypatch):
    monkeypatch.setattr(tt, "MAX_CACHED_BATCHES", 4)
    batches = iter([{"loss_in": np.array(float(i))} for i in range(6)])
    with pytest.raises(ValueError, match="re-iterable"):
        tt.fit(_NullModel(), _identity_step, batches, tt.FitConfig(steps=10, prefetch=0), state=tt.TrainState({}, (), 0))


def test_fit_needs_a_state():
    with pytest.raises(ValueError, match="init_train_state"):
        tt.fit(_NullModel(), _identity_step, [], tt.FitConfig(steps=1))


def _batches(n):
    return [triplet_batch(seed=i) for i in range(n)]


@pytest.mark.parametrize("optimizer", ["AdamW", "Adafactor", "Shampoo"])
def test_resumed_fit_reproduces_an_uninterrupted_one(tmp_path, optimizer):
    """4 steps straight, against 2 steps, save_train_state, a fresh model
    restored from it and 2 more steps: bit-identical params, with dropout
    0.1 (the masks follow the step) and rolling checkpoints on the way."""
    rank = {"name": "MNRLoss", "scale": 20.0}
    cfg = dict(steps=4, learning_rate=1e-3, warmup_ratio=0.3, optimizer_name=optimizer, prefetch=0, seed=3)

    def fresh():
        _, tm = models("biencoder", "dense", dropout=0.1)
        return tm

    straight = fresh()
    state, tx, sched = tt.init_train_state(straight, tt.FitConfig(**cfg))
    tt.fit(straight, tt.make_biencoder_train_step(straight, tx, rank, None, 4), _batches(4), tt.FitConfig(**cfg),
           sched, state)

    first = fresh()
    state, tx, sched = tt.init_train_state(first, tt.FitConfig(**cfg))
    half = tt.FitConfig(**dict(cfg, steps=2), ckpt_path=str(tmp_path / "ckpt"), ckpt_save_steps=1, ckpt_save_limit=1)
    state = tt.fit(first, tt.make_biencoder_train_step(first, tx, rank, None, 4), _batches(2), half, sched, state)
    tt.save_train_state(str(tmp_path / "state"), state)
    assert sorted(p.name for p in (tmp_path / "ckpt").iterdir()) == ["2"]

    resumed = fresh()
    template, tx, sched = tt.init_train_state(resumed, tt.FitConfig(**cfg))
    state = tt.restore_train_state(str(tmp_path / "state"), template)
    assert state.step == 2 and state.seed == 3
    state = tt.fit(resumed, tt.make_biencoder_train_step(resumed, tx, rank, None, 4), _batches(4)[2:],
                   tt.FitConfig(**dict(cfg, steps=2)), sched, state)
    assert state.step == 4
    want = straight.module.state_dict()
    for k, v in resumed.module.state_dict().items():
        assert torch.equal(v, want[k]), k
    reloaded = BiEncoder.load(str(tmp_path / "ckpt" / "2"), device=DEVICE)
    ids, mask = tokens(np.random.default_rng(1), 3, 9)
    assert torch.equal(reloaded.embed_tokens(*token_tensors(ids, mask, DEVICE)),
                       first.embed_tokens(*token_tensors(ids, mask, DEVICE)))


# ----------------------------------------------------------------------
# samplers and collation
# ----------------------------------------------------------------------
WORDS = "chat chien tribunal jugement contrat travail loi voiture route oiseau forêt tapis salon".split()


def _records(seed=4, n_docs=30):
    rng = np.random.default_rng(seed)
    corpus = [{"id": 100 + i, "article": " ".join(rng.choice(WORDS, size=rng.integers(3, 9))), "description": "t"}
              for i in range(n_docs)]
    def q(qid):
        return {"id": qid, "question": " ".join(rng.choice(WORDS, size=4)),
                "article_ids": [int(x) + 100 for x in rng.choice(n_docs, size=rng.integers(1, 3), replace=False)]}
    questions = {"train": [q(i) for i in range(12)], "dev": [q(50 + i) for i in range(4)], "test": []}
    negatives = {str(i): {"bm25": [100 + (i * 7) % n_docs, 100 + (i * 3 + 1) % n_docs]} for i in range(0, 12, 2)}
    return corpus, questions, negatives


def _loaders():
    corpus, questions, negatives = _records()
    neg = {int(k): v for k, v in negatives.items()}
    return JaxLoader.from_records(corpus, questions, neg), LLeQALoader.from_records(corpus, questions, neg)


@pytest.mark.parametrize("negs", [1, 3])
def test_triplet_sampler_matches_jax(negs):
    jl, tl = _loaders()
    js, ts = jl.biencoder_sampler(negs_per_query=negs, seed=7), tl.biencoder_sampler(negs_per_query=negs, seed=7)
    assert len(js) == len(ts)
    jit, tit = js.epochs(), ts.epochs()
    assert [next(jit) for _ in range(3 * len(js))] == [next(tit) for _ in range(3 * len(ts))]


def test_batches_reiterates_batch_iterator():
    """The CLI's re-iterable batches: each pass is a fresh batch_iterator."""
    b = td.Batches(lambda: iter(range(10)), list, 3)
    assert iter(b) is not b
    assert list(b) == list(b) == list(td.batch_iterator(iter(range(10)), list, 3)) == [[0, 1, 2], [3, 4, 5], [6, 7, 8]]


def test_crossencoder_pairs_match_jax():
    jl, tl = _loaders()
    assert jl.crossencoder_pairs(neg_per_pos=3, seed=5) == tl.crossencoder_pairs(neg_per_pos=3, seed=5)
    corpus = {i: f"doc {i}" for i in range(4)}
    args = (corpus, {0: "q"}, {0: [0, 1, 2, 3]})  # every doc a positive: no negative can be drawn
    assert jd.crossencoder_pairs(*args) == td.crossencoder_pairs(*args)


def test_collation_matches_jax():
    jl, tl = _loaders()
    samples = list(tl.biencoder_sampler(negs_per_query=2, seed=1).samples())[:6]
    scored = [[s[0]] + [(t, float(i)) for i, t in enumerate(s[1:])] for s in samples]
    jenc, tenc = (enc(tok(vocab_size=512), max_query_length=8, max_doc_length=16)
                  for enc, tok in ((JaxTextEncoder, JaxTokenizer), (TextEncoder, WordHashTokenizer)))
    for batch in (samples, scored):
        want, got = jd.collate_biencoder(jenc, batch, 2), td.collate_biencoder(tenc, batch, 2)
        assert sorted(want) == sorted(got)
        for k in want:
            np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]), err_msg=k)
    pairs = [(s[0], s[1]) for s in samples]
    labels = [float(i % 2) for i in range(len(pairs))]
    want = jd.collate_crossencoder(JaxTokenizer(vocab_size=512), pairs, labels, 24)
    got = td.collate_crossencoder(WordHashTokenizer(vocab_size=512), pairs, labels, 24)
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]), err_msg=k)
    stream = list(range(10))
    for drop_last in (True, False):
        assert list(jd.batch_iterator(stream, list, 4, drop_last)) == list(td.batch_iterator(stream, list, 4, drop_last))


def test_export_colbert_files_match_jax(tmp_path):
    jl, tl = _loaders()
    jp, tp = jl.export_colbert_files(str(tmp_path / "jax")), tl.export_colbert_files(str(tmp_path / "port"))
    assert sorted(jp) == sorted(tp)
    for k in jp:
        with open(jp[k]) as a, open(tp[k]) as b:
            assert a.read() == b.read(), k
