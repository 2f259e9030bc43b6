"""HuggingFace checkpoint import in fusion_tpu_torch against the JAX
package's: tiny checkpoints built locally (``tests/hf_fixtures.py``),
saved as safetensors, ``.bin`` and sharded, in the roberta and bert naming
schemes.  The port reads them without ``transformers``
(``utils/hf_weights.py``); the JAX loaders go through ``transformers``.

  * parameter trees: equal leaf for leaf to ``load_hf_encoder_params``' /
    ``load_hf_t5_encoder_params``' (the same f32 values, read two ways);
  * forwards: f32, atol 1e-5 against JAX, 2e-4 against the HF torch model
    (another attention and GELU arithmetic, as ``tests/test_hf_parity.py``
    holds the JAX trunk);
  * tokenizer ids: equal.
"""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hf_fixtures import WORDS, bert, roberta, save, t5, token_batch, tokenizer_dir
from torch_parity import DEVICE
from torch_train_parity import flat

from fusion_tpu.data.tokenization import HFTokenizer as JaxHFTokenizer
from fusion_tpu.models import encoder as jax_encoder
from fusion_tpu.models import t5 as jax_t5
from fusion_tpu_torch.data.tokenization import HFTokenizer, WordHashTokenizer, tokenizer_from_config
from fusion_tpu_torch.models import convert
from fusion_tpu_torch.models import encoder as port_encoder
from fusion_tpu_torch.models import t5 as port_t5
from fusion_tpu_torch.models.biencoder import BiEncoder
from fusion_tpu_torch.models.colbert import ColBERT
from fusion_tpu_torch.models.crossencoder import CrossEncoder
from fusion_tpu_torch.utils import hf_weights

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F32_TOL, HF_TOL = 1e-5, 2e-4
TEXTS = ["le chat noir dort", "un contrat de travail", "la loi", "juge"]


@pytest.fixture(scope="module")
def hf_dirs(tmp_path_factory):
    """name → (checkpoint directory, the HF model): each format and scheme."""
    root = tmp_path_factory.mktemp("hf")
    rob, brt = roberta(), bert()
    dirs = {
        "roberta_safetensors": (save(rob, root / "rs"), rob),
        "roberta_bin": (save(rob, root / "rb", safe_serialization=False), rob),
        "roberta_sharded": (save(rob, root / "rsh", max_shard_size="60KB"), rob),
        "roberta_bare": (save(rob.roberta, root / "rbare"), rob),
        "bert_safetensors": (save(brt, root / "bs"), brt),
        "bert_sharded_bin": (save(brt, root / "bsh", safe_serialization=False, max_shard_size="60KB"), brt),
    }
    tokenizer_dir(root / "rs")  # the safetensors roberta directory also holds a tokenizer
    return dirs


def test_sharded_fixtures_are_sharded(hf_dirs):
    assert os.path.isfile(os.path.join(hf_dirs["roberta_sharded"][0], "model.safetensors.index.json"))
    assert os.path.isfile(os.path.join(hf_dirs["bert_sharded_bin"][0], "pytorch_model.bin.index.json"))


@pytest.mark.parametrize("name", ["roberta_safetensors", "roberta_bin", "roberta_sharded", "roberta_bare",
                                  "bert_safetensors", "bert_sharded_bin"])
def test_load_hf_encoder_params_matches_jax(hf_dirs, name):
    """Config fields and every leaf equal to the JAX loader's.  A bare trunk
    (no LM head) gives no ``mlm`` subtree: the JAX loader draws one at
    random there."""
    path, _ = hf_dirs[name]
    cfg, params = port_encoder.load_hf_encoder_params(path)
    jcfg, jparams = jax_encoder.load_hf_encoder_params(path)
    fields = [f for f in port_encoder.EncoderConfig.__dataclass_fields__ if f != "dtype"]
    assert {f: getattr(cfg, f) for f in fields} == {f: getattr(jcfg, f) for f in fields}
    assert cfg.dropout == 0.0 and cfg.position_offset == (0 if name.startswith("bert") else 2)
    got, want = flat(params), flat(jparams)
    if name == "roberta_bare":
        assert "mlm" not in params["params"]
        want = {k: v for k, v in want.items() if k[0] == "encoder"}
    assert set(got) == set(want)
    for key, w in want.items():
        assert got[key].dtype == np.float32 and np.array_equal(got[key], w), key


@pytest.mark.parametrize("name", ["roberta_safetensors", "bert_sharded_bin"])
def test_hf_forward_matches_hf_torch_and_jax(hf_dirs, name):
    """The port's EncoderWithMLM on the imported weights: hidden states and
    MLM logits of the attended tokens against the HF torch model and JAX's
    module on JAX's import."""
    path, hf_model = hf_dirs[name]
    cfg, params = port_encoder.load_hf_encoder_params(path)
    module = port_encoder.place(port_encoder.EncoderWithMLM(cfg), torch.float32, DEVICE)
    module.load_state_dict(convert.encoder_with_mlm_state_dict(params))
    ids, mask = token_batch(pad=cfg.pad_token_id)
    with torch.no_grad():
        hidden, logits = module(*port_encoder.token_tensors(ids, mask, DEVICE))
        ref = hf_model(input_ids=torch.as_tensor(ids), attention_mask=torch.as_tensor(mask), output_hidden_states=True)
    jcfg, jparams = jax_encoder.load_hf_encoder_params(path)
    jh, jl = jax_encoder.EncoderWithMLM(jcfg).apply(jparams, jnp.asarray(ids, jnp.int32), jnp.asarray(mask, jnp.int32))
    real = mask.astype(bool)
    np.testing.assert_allclose(hidden.numpy()[real], np.asarray(jh)[real], atol=F32_TOL, rtol=0)
    np.testing.assert_allclose(logits.numpy()[real], np.asarray(jl)[real], atol=F32_TOL, rtol=0)
    np.testing.assert_allclose(hidden.numpy()[real], ref.hidden_states[-1].numpy()[real], atol=HF_TOL, rtol=HF_TOL)
    np.testing.assert_allclose(logits.numpy()[real], ref.logits.numpy()[real], atol=10 * HF_TOL, rtol=10 * HF_TOL)


def test_safetensors_reader_round_trip(tmp_path):
    """``write_safetensors`` / ``read_safetensors``: every dtype, a scalar,
    an empty tensor and a misaligned offset (bf16 of odd length, then f32)
    come back equal; the file also loads in the ``safetensors`` package."""
    tensors = {"a": torch.randn(3, dtype=torch.bfloat16), "b": torch.randn(2, 5), "c": torch.tensor(7),
               "d": torch.zeros(0, 4), "e": torch.arange(6, dtype=torch.int16).reshape(2, 3),
               "f": torch.tensor([True, False]), "g": torch.randn(4, dtype=torch.float16)}
    file = str(tmp_path / "x.safetensors")
    hf_weights.write_safetensors(tensors, file)
    back = hf_weights.read_safetensors(file)
    from safetensors.torch import load_file

    lib = load_file(file)
    for name, t in tensors.items():
        assert back[name].dtype == t.dtype and torch.equal(back[name], t), name
        assert torch.equal(lib[name], t), name


def test_hf_tokenizer_ids_match_jax(hf_dirs):
    """``HFTokenizer`` single and pair encodings equal JAX's, and a
    checkpoint config's ``hf`` tokenizer loads."""
    path = hf_dirs["roberta_safetensors"][0]
    got, want = HFTokenizer(path), JaxHFTokenizer(path)
    for pad_to_max in (True, False):
        for a, b in zip(got(TEXTS, 8, pad_to_max=pad_to_max), want(TEXTS, 8, pad_to_max=pad_to_max)):
            assert a.dtype == np.int32 and np.array_equal(a, b)
    for a, b in zip(got(TEXTS, 8, add_special_tokens=False), want(TEXTS, 8, add_special_tokens=False)):
        assert np.array_equal(a, b)
    for a, b in zip(got.pair(TEXTS[:2], TEXTS[2:], 9), want.pair(TEXTS[:2], TEXTS[2:], 9)):
        assert np.array_equal(a, b)
    assert (got.pad_token_id, got.cls_token_id, got.sep_token_id, got.mask_token_id, got.vocab_size) == (
        want.pad_token_id, want.cls_token_id, want.sep_token_id, want.mask_token_id, want.vocab_size)
    assert got.vocab_size == 5 + len(WORDS)
    assert isinstance(tokenizer_from_config({"kind": "hf", "name_or_path": path}), HFTokenizer)


def test_from_pretrained_hf_three_models(hf_dirs):
    """Each model's ``from_pretrained_hf`` against JAX's on one directory:
    BiEncoder dense (the trunk only) and SPLADE (with the LM head) embed as
    JAX's do; ColBERT and CrossEncoder hold JAX's trunk and a fresh head of
    the same shape; the tokenizer is the directory's, or the hashing one
    where the directory has none (ColBERT, CrossEncoder)."""
    from fusion_tpu.models.biencoder import BiEncoder as JaxBiEncoder
    from fusion_tpu.models.colbert import ColBERT as JaxColBERT
    from fusion_tpu.models.crossencoder import CrossEncoder as JaxCrossEncoder

    path = hf_dirs["roberta_safetensors"][0]
    for head in ("dense", "splade"):
        got = BiEncoder.from_pretrained_hf(path, head, device=DEVICE)
        want = JaxBiEncoder.from_pretrained_hf(path, head)
        assert isinstance(got.text_encoder.tokenizer, HFTokenizer)
        np.testing.assert_allclose(got.encode(TEXTS).numpy(), np.asarray(want.encode(TEXTS)), atol=F32_TOL, rtol=0)
    trunk = convert.encoder_state_dict(jax_encoder.load_hf_encoder_params(path)[1]["params"]["encoder"])
    for cls, jcls, kw in ((ColBERT, JaxColBERT, {"dim": 16}), (CrossEncoder, JaxCrossEncoder, {})):
        got, want = cls.from_pretrained_hf(path, device=DEVICE, **kw), jcls.from_pretrained_hf(path, **kw)
        assert got.cfg.dropout == 0.0
        state = got.module.encoder.state_dict()
        assert all(torch.equal(state[k], v) for k, v in trunk.items())
        wanted_tree, got_tree = flat(want.params), flat(got.flax_tree(got.module.state_dict()))
        assert {k: v.shape for k, v in got_tree.items()} == {k: v.shape for k, v in wanted_tree.items()}
        assert isinstance(got.tokenizer if cls is CrossEncoder else got.text_encoder.tokenizer, HFTokenizer)
        bare = cls.from_pretrained_hf(hf_dirs["roberta_bin"][0], device=DEVICE, **kw)
        assert isinstance(bare.tokenizer if cls is CrossEncoder else bare.text_encoder.tokenizer, WordHashTokenizer)
    with pytest.raises(ValueError, match="masked-LM head"):
        BiEncoder.from_pretrained_hf(hf_dirs["roberta_bare"][0], "splade", device=DEVICE)


@pytest.fixture(scope="module")
def t5_dir(tmp_path_factory):
    return save(t5(), tmp_path_factory.mktemp("hf") / "t5")


def test_load_hf_t5_encoder_params_matches_jax(t5_dir):
    """The encoder subtree and config equal JAX's; with JAX's fresh head
    swapped in, the port's module scores as JAX's (f32, atol 1e-5)."""
    cfg, params = port_t5.load_hf_t5_encoder_params(t5_dir, pooling_mode="mean")
    jcfg, jparams = jax_t5.load_hf_t5_encoder_params(t5_dir, pooling_mode="mean")
    fields = [f for f in port_t5.T5Config.__dataclass_fields__ if f != "dtype"]
    assert {f: getattr(cfg, f) for f in fields} == {f: getattr(jcfg, f) for f in fields}
    got, want = flat(params), flat(jparams)
    assert set(got) == set(want)
    for key, w in want.items():
        if key[0] == "encoder":
            assert np.array_equal(got[key], np.asarray(w)), key
    module = port_t5.T5EncoderForSequenceClassification(cfg)
    module.load_state_dict(convert.t5_crossencoder_state_dict(jparams, cfg))
    ids, mask = token_batch(seed=3, pad=0)
    with torch.no_grad():
        logits = module(torch.as_tensor(ids), torch.as_tensor(mask))
    jl = jax_t5.T5EncoderForSequenceClassification(jcfg).apply(jparams, jnp.asarray(ids, jnp.int32),
                                                               jnp.asarray(mask, jnp.int32))
    np.testing.assert_allclose(logits.numpy(), np.asarray(jl), atol=F32_TOL, rtol=0)


def test_restore_params_bytes_and_camembert_base():
    """``restore_params_bytes`` reads a JAX ``to_bytes`` blob (fused and
    pre-fusion attention layouts) into a module as ``convert`` maps it;
    ``camembert_base`` is JAX's."""
    from flax import serialization

    from fusion_tpu.models.biencoder import BiEncoder as JaxBiEncoder

    jm = JaxBiEncoder(jax_encoder.EncoderConfig.tiny(vocab_size=64), head="dense")
    want = convert.encoder_state_dict(jm.params)
    tree = serialization.to_state_dict(jm.params)
    unfused = jax_encoder.migrate_pre_qkv_params(tree)  # fused: unchanged
    for i in range(2):  # split the fused qkv back into query / key / value
        att = unfused["params"][f"layer_{i}"]["attention"]
        qkv = att.pop("qkv")
        for j, n in enumerate(("query", "key", "value")):
            att[n] = {"kernel": np.asarray(qkv["kernel"])[:, j], "bias": np.asarray(qkv["bias"])[j]}
    for blob in (serialization.to_bytes(jm.params), serialization.msgpack_serialize(unfused)):
        module = port_encoder.Encoder(port_encoder.EncoderConfig.tiny(vocab_size=64))
        assert port_encoder.restore_params_bytes(module, blob) is module
        assert all(torch.equal(module.state_dict()[k], v) for k, v in want.items())
    fields = [f for f in port_encoder.EncoderConfig.__dataclass_fields__ if f != "dtype"]
    got, jcfg = port_encoder.EncoderConfig.camembert_base(remat=True), jax_encoder.EncoderConfig.camembert_base(
        remat=True)
    assert {f: getattr(got, f) for f in fields} == {f: getattr(jcfg, f) for f in fields}


_NO_TRANSFORMERS = """
import sys
for name in ("transformers", "tokenizers", "safetensors"):
    sys.modules[name] = None
sys.path.insert(0, {root!r})
import torch
from fusion_tpu_torch.data.tokenization import WordHashTokenizer
from fusion_tpu_torch.models.colbert import ColBERT
from fusion_tpu_torch.models.encoder import load_hf_encoder_params
from fusion_tpu_torch.models.t5 import load_hf_t5_encoder_params
for path in {paths!r}:
    cfg, params = load_hf_encoder_params(path)
    assert cfg.num_layers == 2 and "mlm" in params["params"], path
model = ColBERT.from_pretrained_hf({paths[0]!r}, dim=16, device="cpu")
assert isinstance(model.text_encoder.tokenizer, WordHashTokenizer)
assert load_hf_t5_encoder_params({t5!r})[0].num_layers == 2
assert "transformers" not in [m for m in sys.modules if sys.modules[m] is not None]
print("loaded")
"""


def test_loaders_run_without_transformers(hf_dirs, t5_dir):
    """In a fresh process where ``transformers``, ``tokenizers`` and
    ``safetensors`` cannot be imported (as on the card's machine), the
    port's loaders still read safetensors, ``.bin`` and sharded checkpoints,
    and ColBERT falls back to the hashing tokenizer."""
    paths = [hf_dirs[n][0] for n in ("roberta_safetensors", "roberta_bin", "roberta_sharded", "bert_sharded_bin")]
    code = _NO_TRANSFORMERS.format(root=ROOT, paths=paths, t5=t5_dir)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300)
    assert out.returncode == 0 and out.stdout.strip() == "loaded", out.stderr[-2000:]


# ----------------------------------------------------------------------
# X-MOD, as tests/test_xmod.py holds the JAX trunk
# ----------------------------------------------------------------------
@pytest.fixture(scope="module")
def xmod_dirs(tmp_path_factory):
    from hf_fixtures import xmod

    root = tmp_path_factory.mktemp("xmod")
    base, mlm = xmod(), xmod(seed=1, mlm=True)
    return {"base": (save(base, root / "base"), base), "mlm": (save(mlm, root / "mlm"), mlm)}


@pytest.mark.parametrize("kind, languages, with_mlm", [("base", None, False), ("base", ["de_DE", "fr_XX"], False),
                                                        ("mlm", None, True)], ids=["all", "subset", "mlm"])
def test_load_hf_xmod_params_matches_jax(xmod_dirs, kind, languages, with_mlm):
    from fusion_tpu.models import xmod as jax_xmod
    from fusion_tpu_torch.models import xmod as port_xmod

    path = xmod_dirs[kind][0]
    cfg, params = port_xmod.load_hf_xmod_params(path, languages=languages, with_mlm=with_mlm)
    jcfg, jparams = jax_xmod.load_hf_xmod_params(path, languages=languages, with_mlm=with_mlm)
    fields = [f for f in port_xmod.XmodConfig.__dataclass_fields__ if f != "dtype"]
    assert {f: getattr(cfg, f) for f in fields} == {f: getattr(jcfg, f) for f in fields}
    got, want = flat(params), flat(jparams)
    assert set(got) == set(want)
    assert all(np.array_equal(got[k], np.asarray(w)) for k, w in want.items())
    with pytest.raises(ValueError, match="no adapters"):
        port_xmod.load_hf_xmod_params(path, languages=["xx_YY"])


def _xmod_encoder(path, **kw):
    from fusion_tpu_torch.models import xmod as port_xmod

    cfg, params = port_xmod.load_hf_xmod_params(path, **kw)
    module = port_xmod.XmodEncoder(cfg)
    module.load_state_dict(convert.state_dict_from_flax(module, cfg.num_heads, params))
    return cfg, module.eval()


@pytest.mark.parametrize("lang", ["fr_XX", "en_XX", "de_DE"])
def test_xmod_forward_per_language_matches_hf_and_jax(xmod_dirs, lang):
    """Each adapter: the port's trunk against JAX's (atol 1e-5) and the HF
    torch model (2e-4); the languages give different outputs."""
    from fusion_tpu.models import xmod as jax_xmod

    path, hf_model = xmod_dirs["base"]
    cfg, module = _xmod_encoder(path)
    jcfg, jparams = jax_xmod.load_hf_xmod_params(path)
    ids, mask = token_batch(seed=5)
    module.lang_idx = cfg.lang_index(lang)
    with torch.no_grad():
        got = module(*port_encoder.token_tensors(ids, mask, DEVICE)).numpy()
        other = (module.lang_idx + 1) % 3
        module.lang_idx = other
        moved = module(*port_encoder.token_tensors(ids, mask, DEVICE)).numpy()
        hf_model.set_default_language(lang)
        ref = hf_model(input_ids=torch.as_tensor(ids), attention_mask=torch.as_tensor(mask)).last_hidden_state
    want = jax_xmod.XmodEncoder(jcfg).apply(jparams, jnp.asarray(ids, jnp.int32), jnp.asarray(mask, jnp.int32),
                                            lang_idx=jcfg.lang_index(lang))
    real = mask.astype(bool)
    np.testing.assert_allclose(got[real], np.asarray(want)[real], atol=F32_TOL, rtol=0)
    np.testing.assert_allclose(got[real], ref.numpy()[real], atol=HF_TOL, rtol=HF_TOL)
    assert np.abs(moved - got)[real].max() > 1e-4


def test_xmod_models_match_jax_and_checkpoints_cross_load(xmod_dirs, tmp_path):
    """``from_xmod``: BiEncoder dense and SPLADE (the LM head of an
    ``XmodForMaskedLM``) encode as JAX's; ColBERT holds JAX's trunk and a
    fresh head.  A port-saved X-MOD checkpoint loads in JAX and a JAX-saved
    one in the port, encoding alike (atol 1e-5)."""
    from fusion_tpu.models.biencoder import BiEncoder as JaxBiEncoder
    from fusion_tpu.models.colbert import ColBERT as JaxColBERT

    for head, kind in (("dense", "base"), ("splade", "mlm")):
        path = xmod_dirs[kind][0]
        got = BiEncoder.from_xmod(path, head, languages=["en_XX", "fr_XX"], lang="fr", device=DEVICE)
        want = JaxBiEncoder.from_xmod(path, head, languages=["en_XX", "fr_XX"], lang="fr")
        np.testing.assert_allclose(got.encode(TEXTS).numpy(), np.asarray(want.encode(TEXTS)), atol=F32_TOL, rtol=0)
        got.save(str(tmp_path / f"port_{head}"))
        want.save(str(tmp_path / f"jax_{head}"))
        np.testing.assert_allclose(
            np.asarray(JaxBiEncoder.load(str(tmp_path / f"port_{head}")).set_language("fr").encode(TEXTS)),
            got.encode(TEXTS).numpy(), atol=F32_TOL, rtol=0)
        back = BiEncoder.load(str(tmp_path / f"jax_{head}"), device=DEVICE).set_language("fr")
        np.testing.assert_allclose(back.encode(TEXTS).numpy(), np.asarray(want.encode(TEXTS)), atol=F32_TOL, rtol=0)
        assert back.encode(TEXTS).shape == got.set_language("en").encode(TEXTS).shape
    path = xmod_dirs["base"][0]
    got = ColBERT.from_xmod(path, lang="de", dim=16, device=DEVICE)
    want = JaxColBERT.from_xmod(path, lang="de", dim=16)
    assert got.cfg.languages == want.cfg.languages and got.module.encoder.lang_idx == 2
    _, trunk = _xmod_encoder(path)
    state = got.module.encoder.state_dict()
    assert all(torch.equal(state[k], v) for k, v in trunk.state_dict().items())
    assert {k: v.shape for k, v in flat(got.flax_tree(got.module.state_dict())).items()} == {
        k: v.shape for k, v in flat(want.params).items()}
    got.save(str(tmp_path / "colbert"))
    loaded = JaxColBERT.load(str(tmp_path / "colbert")).set_language("de")
    ids, mask = token_batch(seed=6)
    np.testing.assert_allclose(
        np.asarray(loaded.embed_tokens(loaded.params, jnp.asarray(ids, jnp.int32), jnp.asarray(mask, jnp.float32))),
        got.embed_tokens(*port_encoder.token_tensors(ids, mask, DEVICE)).numpy(), atol=F32_TOL, rtol=0)


def test_xmod_views_labels_and_recipe(xmod_dirs):
    """The int8 view keeps the adapters' f32 parameters and the pinned
    language and scores as JAX's int8 view; the fine-tuning labels equal
    JAX's; the utilities pin and freeze; a flash train step on the X-MOD
    trunk goes through ``MaskedAttention`` and gives the einsum form's
    gradients (atol 1e-5)."""
    from fusion_tpu.models.biencoder import BiEncoder as JaxBiEncoder
    from fusion_tpu.models.xmod import xmod_finetune_labels as jax_labels
    from fusion_tpu.utils.xmod import xmod_language_code as jax_code
    from fusion_tpu_torch.models.xmod import xmod_finetune_labels
    from fusion_tpu_torch.utils import xmod as port_utils

    path, hf_model = xmod_dirs["base"]
    got = BiEncoder.from_xmod(path, lang="de", device=DEVICE)
    want = JaxBiEncoder.from_xmod(path, lang="de")
    q8, j8 = got.quantized(), want.quantized()
    assert q8.module.layers[0].adapters.down_kernel.dtype == torch.float32 and q8.module.lang_idx == 2
    np.testing.assert_allclose(q8.encode(TEXTS).numpy(), np.asarray(j8.encode(TEXTS)), atol=1e-4, rtol=0)
    paths = [lay.path for lay in convert.flax_layouts(got.module, got.cfg.num_heads).values()]
    want_labels = {tuple(str(getattr(k, "key", k)) for k in p): v
                   for p, v in __import__("jax").tree_util.tree_flatten_with_path(jax_labels(want.params))[0]}
    assert {("params",) + p: v for p, v in xmod_finetune_labels(paths).items()} == want_labels
    for lang in ("fr", "de_DE", "en"):
        assert port_utils.xmod_language_code(lang) == jax_code(lang)
    assert port_utils.set_xmod_language(got, "fr") is got and got.module.lang_idx == 0
    port_utils.set_xmod_language(hf_model, "en")  # an HF torch model, as in JAX
    port_utils.prepare_xmod_for_finetuning(got, "fr")
    frozen = {n for n, p in got.module.named_parameters() if not p.requires_grad}
    assert frozen == {n for n in dict(got.module.named_parameters()) if "adapter" in n or "embeddings" in n}
    grads = []
    for impl in ("einsum", "flash"):
        model = ColBERT.from_xmod(path, lang="fr", dim=16, device=DEVICE).with_attention(impl)
        ids, mask = token_batch(seed=7)
        tensors = port_encoder.token_tensors(ids, mask, DEVICE)
        out = model.embed_tokens_train(*tensors)
        assert (out.grad_fn is not None) and (impl == "einsum" or _has_masked_attention(out.grad_fn))
        out.square().sum().backward()
        grads.append({n: p.grad.clone() for n, p in model.module.named_parameters()})
    for n, g in grads[0].items():
        torch.testing.assert_close(grads[1][n], g, atol=1e-5, rtol=0)


def _has_masked_attention(fn, seen=None) -> bool:
    """The autograd graph below ``fn`` holds a ``MaskedAttention`` node."""
    seen = set() if seen is None else seen
    stack = [fn]
    while stack:
        node = stack.pop()
        if node is None or id(node) in seen:
            continue
        seen.add(id(node))
        if node.name() == "MaskedAttentionBackward":
            return True
        stack.extend(n for n, _ in node.next_functions)
    return False
