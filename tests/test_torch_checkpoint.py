"""Model checkpoints between the JAX package and fusion_tpu_torch.

The port reads and writes ``params.msgpack`` with its own msgpack code
(``fusion_tpu_torch/utils/flax_msgpack.py``): held byte for byte to
``flax.serialization`` on seeded trees (nested dicts and lists, f32 / bf16 /
int arrays, numpy scalars, flax's chunked form of an oversized leaf), and
read back to equal leaves.  Each model saved by the JAX package loads in the
port and the port's save loads in the JAX package: encodings and logits at
atol 1e-5 (f32 on the CPU; the two packages' forwards differ by ~1e-6)."""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization
from torch_parity import DEVICE

from fusion_tpu.data.tokenization import WordHashTokenizer as JaxWordHash
from fusion_tpu.models.biencoder import BiEncoder as JaxBiEncoder
from fusion_tpu.models.colbert import ColBERT as JaxColBERT
from fusion_tpu.models.crossencoder import CrossEncoder as JaxCrossEncoder
from fusion_tpu.models.encoder import EncoderConfig as JaxConfig
from fusion_tpu.models.encoder import migrate_pre_qkv_params as jax_migrate
from fusion_tpu_torch.data.tokenization import WordHashTokenizer, tokenizer_config, tokenizer_from_config
from fusion_tpu_torch.models import checkpoint
from fusion_tpu_torch.models.biencoder import BiEncoder
from fusion_tpu_torch.models.colbert import ColBERT
from fusion_tpu_torch.models.crossencoder import CrossEncoder
from fusion_tpu_torch.utils import flax_msgpack

ATOL = 1e-5
QUERIES = ["le chat noir dort", "tribunal jugement de la loi", "contrat", ""]
PAIRS = [("le chat noir", "le chat dort sur le tapis"), ("loi", "la loi protège les consommateurs"), ("x", "")]


def _tree(seed: int) -> dict:
    rng = np.random.default_rng(seed)
    return {
        "params": {
            "dense": {"kernel": rng.normal(size=(7, 5)).astype(np.float32), "bias": np.zeros(5, np.float32)},
            "bf16": np.asarray(jnp.asarray(rng.normal(size=(3, 4)), jnp.bfloat16)),
            "ints": rng.integers(-1000, 1000, size=(2, 3, 4)).astype(np.int32),
            "u8": rng.integers(0, 255, size=17).astype(np.uint8),
            "empty": np.zeros((0, 3), np.float32),
        },
        "step": np.int64(seed),
        "lr": np.float32(0.5),
        "meta": [1, -3, 300, -70_000, 2**40, 1.5, "nom", None, True, False, "é" * 40],
    }


def _assert_leaves_equal(got, want):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for key in want:
            _assert_leaves_equal(got[key], want[key])
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _assert_leaves_equal(g, w)
    elif isinstance(want, (np.ndarray, np.generic)) and want.dtype == jnp.bfloat16:
        assert isinstance(got, torch.Tensor) and got.dtype == torch.bfloat16
        np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, np.float32))
    elif isinstance(want, (np.ndarray, np.generic)):
        assert got.dtype == want.dtype and np.shape(got) == np.shape(want)
        np.testing.assert_array_equal(got, want)
    else:
        assert got == want and type(got) is type(want)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_msgpack_reads_what_flax_writes(seed):
    tree = _tree(seed)
    _assert_leaves_equal(flax_msgpack.unpackb(serialization.msgpack_serialize(tree)), tree)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_msgpack_writes_flax_bytes(seed):
    """Byte-identical to flax's writer, and flax reads it back."""
    tree = _tree(seed)
    ours = flax_msgpack.packb(flax_msgpack.unpackb(serialization.msgpack_serialize(tree)))
    assert ours == serialization.msgpack_serialize(tree)
    _assert_leaves_equal(flax_msgpack.unpackb(ours), tree)
    back = serialization.msgpack_restore(ours)
    assert back["params"]["bf16"].dtype == jnp.bfloat16


def test_msgpack_writes_torch_tensors_as_flax_arrays():
    t = torch.randn(3, 5, generator=torch.Generator().manual_seed(0))
    back = serialization.msgpack_restore(flax_msgpack.packb({"f32": t, "bf16": t.to(torch.bfloat16)}))
    np.testing.assert_array_equal(back["f32"], t.numpy())
    assert back["bf16"].dtype == jnp.bfloat16
    np.testing.assert_array_equal(np.asarray(back["bf16"], np.float32), t.to(torch.bfloat16).float().numpy())


def test_msgpack_chunked_leaves(monkeypatch):
    """flax splits a leaf over MAX_CHUNK_SIZE bytes into a chunked map: the
    port joins it on read and writes the same form."""
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 64)
    monkeypatch.setattr(flax_msgpack, "MAX_CHUNK_SIZE", 64)
    rng = np.random.default_rng(3)
    tree = {"big": rng.normal(size=(9, 7)).astype(np.float32), "small": np.arange(3, dtype=np.int32),
            "nested": {"big16": np.asarray(jnp.asarray(rng.normal(size=(50,)), jnp.bfloat16))}}
    flax_bytes = serialization.msgpack_serialize(tree)
    assert b"__msgpack_chunked_array__" in flax_bytes
    _assert_leaves_equal(flax_msgpack.unpackb(flax_bytes), tree)
    # flax's writer sorts a copied tree's keys; written in that order, the
    # port's bytes are flax's
    assert flax_msgpack.packb(flax_msgpack.unpackb(flax_bytes)) == flax_bytes
    back = serialization.msgpack_restore(flax_msgpack.packb(tree))
    np.testing.assert_array_equal(back["big"], tree["big"])
    np.testing.assert_array_equal(np.asarray(back["nested"]["big16"], np.float32),
                                  np.asarray(tree["nested"]["big16"], np.float32))


def test_msgpack_rejects_truncated_data():
    blob = serialization.msgpack_serialize(_tree(0))
    with pytest.raises(ValueError):
        flax_msgpack.unpackb(blob[:-3])


def test_migrate_pre_qkv_params_matches_jax():
    rng = np.random.default_rng(4)
    att = {n: {"kernel": rng.normal(size=(8, 2, 4)).astype(np.float32), "bias": rng.normal(size=(2, 4)).astype(np.float32)}
           for n in ("query", "key", "value")}
    att["out"] = {"kernel": rng.normal(size=(2, 4, 8)).astype(np.float32)}
    tree = {"params": {"layer_0": {"attention": att, "ffn_in": {"bias": np.ones(3, np.float32)}}}}
    want, got = jax_migrate(tree), checkpoint.migrate_pre_qkv_params(tree)
    _assert_leaves_equal(got, {k: v for k, v in want.items()})


def test_tokenizer_config_round_trip_and_hf_raises(tmp_path):
    """The hashing tokenizer's config round trip; an ``hf`` tokenizer that
    cannot be loaded (a local directory without tokenizer files) raises, as
    in JAX (``test_torch_hf.py`` loads one)."""
    tok = WordHashTokenizer(vocab_size=777, lowercase=False)
    assert tokenizer_config(tok) == {"kind": "wordhash", "vocab_size": 777, "lowercase": False}
    back = tokenizer_from_config(tokenizer_config(tok))
    assert (back.vocab_size, back.lowercase) == (777, False)
    assert tokenizer_from_config(None) is None
    from fusion_tpu.data.tokenization import tokenizer_config as jax_tokenizer_config

    assert jax_tokenizer_config(JaxWordHash(vocab_size=777, lowercase=False)) == tokenizer_config(tok)
    with pytest.raises(RuntimeError, match="could not be loaded"):
        tokenizer_from_config({"kind": "hf", "name_or_path": str(tmp_path)})


MODELS = {
    "dense": (lambda cfg: JaxBiEncoder(cfg, head="dense", max_query_length=12, max_doc_length=20, pooling="cls",
                                       similarity="dot_score"), BiEncoder),
    "splade": (lambda cfg: JaxBiEncoder(cfg, head="splade", max_query_length=12, max_doc_length=20,
                                        query_prefix="q: ", pruning_topk=9), BiEncoder),
    "colbert": (lambda cfg: JaxColBERT(cfg, dim=8, max_query_length=10, max_doc_length=16), ColBERT),
    "crossencoder": (lambda cfg: JaxCrossEncoder(cfg, max_length=24), CrossEncoder),
}


def _outputs(name, model, jax_side: bool) -> np.ndarray:
    if name == "crossencoder":
        return np.asarray(model.predict(PAIRS, apply_sigmoid=False))
    if name == "colbert":
        out = model.encode_queries(QUERIES)[0]
    else:
        out = model.encode(QUERIES)
    return np.asarray(out) if jax_side else out.float().numpy()


@pytest.mark.parametrize("name", sorted(MODELS))
def test_jax_checkpoint_loads_in_the_port(name, tmp_path):
    make, port_cls = MODELS[name]
    jax_model = make(JaxConfig.tiny(vocab_size=300))
    jax_model.save(str(tmp_path))
    got = port_cls.load(str(tmp_path), device=DEVICE)
    assert got.device == torch.device(DEVICE) and got.cfg.dtype == torch.float32
    np.testing.assert_allclose(_outputs(name, got, False), _outputs(name, jax_model, True), atol=ATOL, rtol=0)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_port_checkpoint_loads_in_jax(name, tmp_path):
    make, port_cls = MODELS[name]
    jax_model = make(JaxConfig.tiny(vocab_size=300))
    jax_model.save(str(tmp_path / "jax"))
    port_model = port_cls.load(str(tmp_path / "jax"), device=DEVICE)
    port_model.save(str(tmp_path / "port"))
    with open(tmp_path / "port" / checkpoint.CONFIG_FILENAME) as f:
        config = json.load(f)
    with open(tmp_path / "jax" / checkpoint.CONFIG_FILENAME) as f:
        jax_config = json.load(f)
    assert set(config) == set(jax_config)
    assert config["__version__"]["fusion_tpu_torch"] and config["__version__"]["torch"] == torch.__version__
    assert {k: v for k, v in config.items() if k != "__version__"} == {
        k: v for k, v in jax_config.items() if k != "__version__"
    }
    back = type(jax_model).load(str(tmp_path / "port"))
    np.testing.assert_allclose(_outputs(name, back, True), _outputs(name, jax_model, True), atol=0, rtol=0)
    np.testing.assert_allclose(_outputs(name, port_model, False), _outputs(name, back, True), atol=ATOL, rtol=0)


def test_port_model_saved_from_bf16_loads_bit_equal(tmp_path):
    """A bf16 model's weights are written as their exact f32 values, so a
    bf16 load reproduces its outputs bit for bit."""
    from fusion_tpu_torch.models.encoder import EncoderConfig

    model = BiEncoder(EncoderConfig.tiny(vocab_size=300, dtype=torch.bfloat16), head="splade", seed=5, device=DEVICE)
    model.save(str(tmp_path))
    back = BiEncoder.load(str(tmp_path), device=DEVICE, dtype=torch.bfloat16)
    assert torch.equal(model.encode(QUERIES), back.encode(QUERIES))
    assert os.path.getsize(tmp_path / checkpoint.PARAMS_FILENAME) > 0


@pytest.mark.parametrize("entry, match", [
    ({"languages": ["fr"]}, "X-MOD"),
    ({"quantize": "int8"}, "int8"),
])
def test_unported_trunks_raise(entry, match):
    """Both trunks are ported now: an X-MOD entry loads as an ``XmodConfig``
    (test_torch_hf.py holds its models to JAX's), an int8 trunk with
    ``quantize`` set (test_torch_int8_views.py holds its scores to JAX's)."""
    base = checkpoint.encoder_config_dict(__import__(
        "fusion_tpu_torch.models.encoder", fromlist=["EncoderConfig"]).EncoderConfig.tiny())
    if "languages" in entry:
        cfg = checkpoint.encoder_config_from_dict({**base, **entry})
        assert type(cfg).__name__ == "XmodConfig" and cfg.languages == ("fr",), match
        return
    assert checkpoint.encoder_config_from_dict({**base, **entry}).quantize == match
