"""Data- and tensor-parallel training of the port (``train/trainer.py``
with a mesh, ``parallel/sharding.py``'s training half, the CLI's
data-parallel runs) against the JAX package's sharded steps.

Each family's step (DPR MNRL, SPLADE InfoNCE with in-batch negatives and
FLOPS regularizers, ColBERT CE, the cross-encoder's BCE, and the same SPLADE
loss on an X-MOD trunk through its second adapter and the BCE on a T5
cross-encoder, whose trunk every ``model`` rank computes whole) runs 3 steps in
two gloo pods of the port (``tests/torch_pod.py``, mode ``train``): 2
processes on a ``data`` = 2 mesh and 4 on ``data`` = 2 × ``model`` = 2.
The parent runs JAX's step on ``make_mesh(data, model, 1,
jax.devices()[:n])`` of the conftest's CPU devices from the same converted
weights and batches, at dropout 0, and holds the losses and the final
parameters at ``rtol=2e-4, atol=1e-5`` (``tests/test_distributed.py``'s
tolerance); of the qkv biases the key third is left out (its gradient is
f32 noise, see ``_assert_params``).  Under ``model`` = 2 the optimizers run
on whole leaves: AdamW with an active clip and Adafactor at that tolerance
(Adafactor's query and value biases at the 5e-5
``test_torch_train_optimizers.py`` states), Shampoo at its stated 1.5e-4
absolute (``eigh``'s null eigenvalues are each run's own noise; its qkv
biases at 5e-4, see ``OPTIMIZERS``), each against JAX's sharded step and
the port's own one-device step.  At dropout 0.1 the parallel step equals the
port's one-device step over the global batch (the masks are drawn at the
global shape).  ``encoder_param_spec`` and ``shard_params`` are held leaf by
leaf to JAX's specs and ``addressable_shards``; the gradient half of
``tests/multihost_worker.py`` runs in both pods; and the CLI trains in a
2-rank pod under torchrun's variables, its ``final/`` held to the JAX CLI's
data-parallel run.
"""

import json
import os
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_cli import _fixture
from test_torch_train import BIENCODER_CASES, FIT
from test_torch_train_optimizers import OPTIMIZER_CASES, WIDE
from torch_pod import start_pod
from torch_train_parity import V, flat, jax_batch, models, pair_batch, triplet_batch

from fusion_tpu.parallel import sharding as jsharding
from fusion_tpu.train import trainer as jt
from fusion_tpu_torch.parallel import sharding
from fusion_tpu_torch.train import trainer as tt

RTOL, ATOL = 2e-4, 1e-5
DENSE, SPLADE = BIENCODER_CASES["dense_mnrl"], BIENCODER_CASES["splade_infonce_ib_flops"]
# name → (kind, head, rank loss, regularizers, encoder config, fit config, tolerances vs JAX)
FAMILIES = {
    "dpr_mnrl": ("biencoder", "dense", DENSE[1], None, {}, FIT, {}),
    "splade_infonce_ib_flops": ("biencoder", "splade", SPLADE[1], SPLADE[2], {}, FIT, {}),
    "colbert_ce": ("colbert", None, None, None, {}, FIT, {}),
    "crossencoder_bce": ("crossencoder", None, None, None, {}, FIT, {}),
    "xmod_splade": ("biencoder", "splade", SPLADE[1], SPLADE[2], {}, FIT, {}),
    "t5_crossencoder_bce": ("crossencoder", None, None, None, {}, FIT, {}),
}
# the trunk of each case that is not the BERT-style one (torch_train_parity.models)
TRUNKS = {"xmod_splade": "xmod", "t5_crossencoder_bce": "t5"}
OPTIMIZERS = {
    "adamw_clip": ("biencoder", "dense", DENSE[1], None, WIDE, dict(FIT, max_grad_norm=1e-3), {}),
    "adafactor": ("biencoder", "dense", DENSE[1], None, WIDE, dict(FIT, optimizer_name="Adafactor"),
                  {"qkv_bias_atol": OPTIMIZER_CASES["Adafactor"]["qkv_bias_atol"]}),
    # Shampoo's preconditioner of a qkv bias mixes the key third's noise into
    # the query and value thirds: 2.3e-4 apart from the one-device step
    "shampoo": ("biencoder", "dense", DENSE[1], None, WIDE, dict(FIT, optimizer_name="Shampoo"),
                {**OPTIMIZER_CASES["Shampoo"], "qkv_bias_atol": 5e-4}),
}
DROPOUT = {"dropout": ("biencoder", "dense", DENSE[1], None, {"dropout": 0.1}, FIT, {})}
CASES = {**FAMILIES, **OPTIMIZERS, **DROPOUT}
MESHES = {2: (2, 1), 4: (2, 2)}  # pod size → (data, model)
# (case, pod size) held to JAX: each family on both meshes, the optimizers under model = 2
JAX_RUNS = [(name, n) for n in MESHES for name in FAMILIES] + [(name, 4) for name in OPTIMIZERS]


def _batch(kind):
    if kind == "crossencoder":
        return pair_batch()
    return triplet_batch(float_masks=kind == "colbert")


def _jax_step(kind, jm, tx, rank, reg, mesh):
    if kind == "colbert":
        return jt.make_colbert_train_step(jm, tx, loss_name="ce", mesh=mesh)
    if kind == "crossencoder":
        return jt.make_crossencoder_train_step(jm, tx, mesh=mesh)
    return jt.make_biencoder_train_step(jm, tx, rank, reg, 10, mesh=mesh)


def _jax_three_steps(name, n):
    kind, head, rank, reg, cfg_kw, fit, _ = CASES[name]
    jm, _ = models(kind, head or "dense", TRUNKS.get(name, "bert"), **cfg_kw)
    state, tx, _ = jt.init_train_state(jm, jt.FitConfig(**fit))
    # the JAX Shampoo state holds one buffer twice, which the donation refuses
    state = state._replace(opt_state=jax.tree_util.tree_map(jnp.copy, state.opt_state))
    data, model = MESHES[n]
    mesh = jsharding.make_mesh(data, model, 1, jax.devices()[:n])
    step = _jax_step(kind, jm, tx, rank, reg, mesh)
    state = step.place_state(state)
    batch, losses = jax_batch(_batch(kind)), []
    for _ in range(3):
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
    return losses, flat(jax.device_get(state.params))


def _payload(parallel, alone=()):
    """The pod's inputs: every case's converted weights and batch, the
    names run on the mesh (``parallel``) and on one device by rank 0
    (``alone``)."""
    cases = {}
    for name in CASES:
        kind, head, rank, reg, cfg_kw, fit, _ = CASES[name]
        trunk = TRUNKS.get(name, "bert")
        _, tm = models(kind, head or "dense", trunk, **cfg_kw)
        cases[name] = {"kind": kind, "head": head, "trunk": trunk, "rank": rank, "reg": reg, "fit": fit,
                       "cfg": {"vocab_size": V, **cfg_kw}, "batch": _batch(kind),
                       "state_dict": {k: v.detach().clone() for k, v in tm.module.state_dict().items()}}
    return {"cases": cases, "parallel": list(parallel), "alone": list(alone)}


@pytest.fixture(scope="module")
def pods(tmp_path_factory):
    """Both pods start together; the parent compiles and runs JAX's steps
    meanwhile, several at once (XLA compiles outside the GIL)."""
    started = {}
    for n in MESHES:
        out = tmp_path_factory.mktemp(f"train_pod{n}")
        parallel = [name for name in CASES if n == 4 or name not in OPTIMIZERS]
        # the one-device steps ride on the smaller pod's rank 0
        alone = [*OPTIMIZERS, *DROPOUT, "dpr_mnrl"] if n == 2 else []
        torch.save(_payload(parallel, alone), out / "payload.pt")
        started[n] = start_pod(out, "train", nproc=n, timeout=420)
    with ThreadPoolExecutor(6) as pool:
        want = dict(zip(JAX_RUNS, pool.map(lambda run: _jax_three_steps(*run), JAX_RUNS)))
    return {n: pod.results() for n, pod in started.items()}, want


def _assert_params(got, want, tol):
    """Every leaf within ``tol``; of the qkv biases, the query and value
    thirds: the key third's gradient is f32 noise (a key bias adds a
    constant to a query's logits, which the softmax cancels), which Adam's
    and Adafactor's scaling turn into steps of the lr of either sign, in
    either package."""
    rtol, atol = (0, tol["param_atol"]) if "param_atol" in tol else (RTOL, ATOL)
    qkv_bias_atol = tol.get("qkv_bias_atol")
    got = flat(got)
    assert set(got) == set(want)
    for k, w in want.items():
        g = np.asarray(got[k])
        if k[-3:] == ("attention", "qkv", "bias"):
            np.testing.assert_allclose(g[[0, 2]], w[[0, 2]], rtol=0 if qkv_bias_atol else rtol,
                                       atol=qkv_bias_atol or atol, err_msg=str(k))
        else:
            np.testing.assert_allclose(g, w, rtol=rtol, atol=atol, err_msg=str(k))


@pytest.mark.parametrize("name, n", JAX_RUNS, ids=[f"{name}-{'data2' if n == 2 else 'data2_model2'}"
                                                    for name, n in JAX_RUNS])
def test_parallel_steps_match_jax_sharded_steps(pods, name, n):
    results, want = pods
    losses, params = want[(name, n)]
    tol = CASES[name][6]
    for rank, report in enumerate(results[n]):
        got = report["cases"][name]
        np.testing.assert_allclose(got["losses"], losses, rtol=tol.get("loss_rtol", RTOL), atol=ATOL,
                                   err_msg=f"rank {rank}")
        _assert_params(got["params"], params, tol)
    if name in OPTIMIZERS:  # and the port's own one-device steps
        alone = results[2][0]["alone"][name]
        np.testing.assert_allclose(results[n][0]["cases"][name]["losses"], alone["losses"],
                                   rtol=tol.get("loss_rtol", RTOL), atol=ATOL)
        _assert_params(results[n][0]["cases"][name]["params"], flat(alone["params"]), tol)


@pytest.mark.parametrize("n", sorted(MESHES), ids=["data2", "data2_model2"])
def test_parallel_dropout_step_equals_the_one_device_step(pods, n):
    """At dropout 0.1 the masks are drawn at the global shape (rows, and
    heads for the probabilities) and sliced, so the parallel step is the
    one-device step over the global batch."""
    results, _ = pods
    alone = results[2][0]["alone"]["dropout"]
    for report in results[n]:
        got = report["cases"]["dropout"]
        np.testing.assert_allclose(got["losses"], alone["losses"], rtol=RTOL, atol=ATOL)
        _assert_params(got["params"], flat(alone["params"]), {})
    no_dropout = results[2][0]["alone"]["dpr_mnrl"]
    assert not np.allclose(alone["losses"][1:], no_dropout["losses"][1:], rtol=1e-6)  # the masks took effect


@pytest.mark.parametrize("n", sorted(MESHES), ids=["data2", "data2_model2"])
def test_gradient_half_of_the_multihost_worker(pods, n):
    """The gradient of ``mean((x @ w)^2)`` over the rows of every rank
    equals the full batch's (``tests/multihost_worker.py:187-205``)."""
    results, _ = pods
    for report in results[n]:
        half = report["gradient_half"]
        np.testing.assert_allclose(half["sharded"], half["full"], rtol=1e-6, atol=1e-7)


def test_every_rank_of_a_pod_ends_with_the_same_parameters(pods):
    results, _ = pods
    for n, reports in results.items():
        for name in reports[0]["cases"]:
            first = flat(reports[0]["cases"][name]["params"])
            for report in reports[1:]:
                other = flat(report["cases"][name]["params"])
                for k in first:
                    np.testing.assert_array_equal(other[k], first[k], err_msg=f"{n} {name} {k}")
            # one gradient bucket over data, one over model (grads and params), the
            # forward's gathers and the Megatron pair: a fixed count every step
            assert reports[0]["cases"][name]["collectives_per_step"] > 0


# ----------------------------------------------------------------------
# the tensor-parallel rules
# ----------------------------------------------------------------------
SPEC_MODELS = {
    "trunk": ("biencoder", "dense", "bert"), "splade": ("biencoder", "splade", "bert"),
    "colbert": ("colbert", None, "bert"), "crossencoder": ("crossencoder", None, "bert"),
    "xmod": ("biencoder", "splade", "xmod"), "t5": ("crossencoder", None, "t5"),
}


def _leaves(tree, prefix=(), leaf=lambda x: x) -> dict:
    """{path: leaf(value)} of a nested dict, a leading "params" dropped."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, prefix + (k,), leaf))
        return out
    return {prefix[1:] if prefix[:1] == ("params",) else prefix: leaf(tree)}


@pytest.mark.parametrize("which", sorted(SPEC_MODELS))
def test_encoder_param_spec_equals_jax(which):
    kind, head, trunk = SPEC_MODELS[which]
    jm, tm = models(kind, head or "dense", trunk)
    want = _leaves(jsharding.encoder_param_spec(jm.params), leaf=tuple)
    got = _leaves(sharding.encoder_param_spec(tm.flax_tree(tm.module.state_dict())), leaf=tuple)
    assert set(got) == set(want)
    for k in want:
        assert got[k] == want[k], k
    if which in ("splade", "xmod"):
        assert got[("mlm", "decoder", "kernel")] == (None, "model")
    if which == "xmod":  # the adapters match no rule: whole on every rank
        assert got[("encoder", "layer_0", "adapters", "down_kernel")] == ()
        assert got[("encoder", "layer_0", "ffn_out", "kernel")] == ("model", None)
    if which == "t5":  # none of T5's leaf names matches a rule
        assert not any(got.values())


def _rank_mesh(data, model, rank):
    return sharding.Mesh(shape={"data": data, "model": model, "index": 1},
                         coords={"data": rank // model, "model": rank % model, "index": 0},
                         groups={"data": None, "model": None, "index": None}, device=torch.device("cpu"))


@pytest.mark.parametrize("which", sorted(SPEC_MODELS))
def test_shard_params_and_shard_module_equal_jax_addressable_shards(which):
    """Each rank's slice of the Flax tree (``shard_params``) and of the
    module's parameters (``shard_module``, in place) equals the shard JAX
    places on that rank's device of a (2, 2, 1) mesh."""
    kind, head, trunk = SPEC_MODELS[which]
    jm, tm = models(kind, head or "dense", trunk)
    mesh = jsharding.make_mesh(2, 2, 1, jax.devices()[:4])
    placed = _leaves(jsharding.shard_params(jm.params, mesh))
    devices = mesh.devices.reshape(-1).tolist()
    tree = tm.flax_tree(tm.module.state_dict())
    for rank in range(4):
        local = flat(sharding.shard_params(tree, _rank_mesh(2, 2, rank)))
        _, part = models(kind, head or "dense", trunk)
        sharding.shard_module(part.module, _rank_mesh(2, 2, rank), part.cfg.num_heads)
        sliced = flat(part.flax_tree(part.module.state_dict()))
        for key, arr in placed.items():
            shard = next(s for s in arr.addressable_shards if s.device == devices[rank])
            np.testing.assert_array_equal(local[key], np.asarray(shard.data), err_msg=f"{rank} {key}")
            np.testing.assert_array_equal(sliced[key], np.asarray(shard.data), err_msg=f"{rank} {key}")


def test_tensor_parallel_t5_raises_with_its_item():
    """Tensor parallelism of the T5 trunk no longer raises:
    ``shard_module`` under ``model = 2`` slices none of its parameters (no
    path matches a rule), gives every submodule the mesh, and the forward
    on one rank is the whole model's; an X-MOD trunk's qkv and FFN are
    sliced and its adapters kept whole."""
    from fusion_tpu_torch.models.t5 import T5Config, T5CrossEncoder

    model = T5CrossEncoder(T5Config.tiny(), max_length=16, device="cpu", param_dtype=torch.float32)
    before = {k: v.clone() for k, v in model.module.state_dict().items()}
    ids, mask = torch.randint(2, 128, (3, 9)), torch.ones(3, 9, dtype=torch.int64)
    want = model.score_tokens(ids, mask)
    mesh = _rank_mesh(1, 2, 0)
    sharding.shard_module(model.module, mesh, model.cfg.num_heads)
    assert not any(hasattr(p, "tp_shard") for p in model.module.parameters())
    assert all(m.tp_mesh is mesh for m in model.module.modules())
    for k, v in model.module.state_dict().items():
        assert torch.equal(v, before[k]), k
    assert torch.equal(model.score_tokens(ids, mask), want)

    _, xm = models("biencoder", "splade", "xmod")
    sharding.shard_module(xm.module, mesh, xm.cfg.num_heads)
    layer = xm.module.encoder.layers[0]
    assert layer.tp_mesh is mesh and layer.ffn_in.weight.shape[0] == xm.cfg.intermediate_size // 2
    assert layer.attention.qkv.weight.shape[0] == 3 * xm.cfg.hidden_size // 2
    assert not any(hasattr(p, "tp_shard") for p in layer.adapters.parameters())


def test_a_step_on_model_ranks_needs_place_state():
    _, tm = models("biencoder", "dense")
    state, tx, _ = tt.init_train_state(tm, tt.FitConfig(**FIT))
    step = tt.make_biencoder_train_step(tm, tx, DENSE[1], None, 10, mesh=_rank_mesh(1, 2, 0))
    with pytest.raises(ValueError, match="place_state"):
        step(state, tt._to_device(triplet_batch(), tm.device))


# ----------------------------------------------------------------------
# the CLI
# ----------------------------------------------------------------------
@pytest.mark.parametrize("batch", [1, 2, 3, 4, 6, 7, 8, 12, 24, 64])
def test_training_mesh_divisor_rule_equals_jax(batch):
    """The ``data`` axis is the largest divisor of the batch that is at most
    the number of ranks, as JAX's ``_training_mesh`` picks it from the
    devices."""
    import argparse

    from fusion_tpu.cli.main import _training_mesh as jax_training_mesh
    from fusion_tpu_torch.cli.main import _data_ranks, _training_mesh

    mesh, _ = jax_training_mesh(argparse.Namespace(data_parallel=True), batch)
    assert _data_ranks(batch, len(jax.devices())) == (1 if mesh is None else mesh.shape["data"])
    assert _data_ranks(24, 16) == 12
    assert _training_mesh(argparse.Namespace(data_parallel=True), batch) == (None, batch)  # no process group


CLI_COMMANDS = {
    "dpr": ["dpr"],
    "splade": ["splade", "--splade_variant", "spladev2"],
    "colbert": ["colbert"],
    "monobert": ["monobert"],
}
CLI_TRAIN = ["--task", "train", "--steps", "3", "--train_batch_size", "4", "--tiny"]


def _init_checkpoints(root) -> dict:
    """The JAX CLI's starting weights of each command, saved by the JAX
    package: dpr and splade start from the seed there (these are those
    weights), colbert and monobert from ``--model_path`` in both CLIs."""
    from fusion_tpu.cli.presets import train_preset
    from fusion_tpu.models.biencoder import BiEncoder as JaxBiEncoder
    from fusion_tpu.models.colbert import ColBERT as JaxColBERT
    from fusion_tpu.models.crossencoder import CrossEncoder as JaxCrossEncoder
    from fusion_tpu.models.encoder import EncoderConfig as JaxConfig

    cfg = JaxConfig.tiny(vocab_size=2048)
    out = {}
    for cmd, head in (("dpr", "dense"), ("splade", "splade")):
        p = train_preset(cmd, "lleqa")
        out[cmd] = JaxBiEncoder(cfg, head=head, max_query_length=min(p.max_query_length, 64),
                                max_doc_length=min(p.max_doc_length, 128), seed=42)
    p = train_preset("colbert", "lleqa")
    out["colbert"] = JaxColBERT(cfg, dim=16, max_query_length=min(p.max_query_length, 32),
                                max_doc_length=min(p.max_doc_length, 64), seed=42)
    out["monobert"] = JaxCrossEncoder(cfg, max_length=32, seed=42)
    paths = {}
    for cmd, model in out.items():
        paths[cmd] = str(root / "init" / cmd)
        model.save(paths[cmd])
    return paths


def _final_params(path):
    from fusion_tpu_torch.utils import flax_msgpack

    with open(os.path.join(path, "params.msgpack"), "rb") as f:
        return flat(flax_msgpack.unpackb(f.read()))


def _start_args(command, init) -> list[str]:
    """colbert and monobert start training from ``--model_path`` in both
    CLIs; dpr and splade from the seed."""
    return ["--model_path", init[command]] if command in ("colbert", "monobert") else []


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    from fusion_tpu.cli.main import main as jax_main

    root = tmp_path_factory.mktemp("cli_parallel")
    fx = root / "fixture.json"
    fx.write_text(json.dumps(_fixture()))
    init = _init_checkpoints(root)
    argvs = [CLI_COMMANDS[c] + CLI_TRAIN + ["--fixture", str(fx), "--output_dir", str(root / "port" / c),
                                            "--device", "cpu"] + _start_args(c, init) for c in CLI_COMMANDS]
    # dpr and splade build their models from the seed in both CLIs: the pod
    # gives the port's the JAX package's starting weights
    seeded = {i: init[c] for i, c in enumerate(CLI_COMMANDS) if not _start_args(c, init)}
    torch.save({"cli": argvs, "init": seeded}, root / "payload.pt")
    pod = start_pod(root, "cli_train", init="env", timeout=420)

    def jax_run(c):  # JAX's data-parallel run over the conftest's CPU devices
        jax_main(CLI_COMMANDS[c] + CLI_TRAIN + ["--fixture", str(fx), "--output_dir", str(root / "jax" / c)]
                 + _start_args(c, init))

    with ThreadPoolExecutor(len(CLI_COMMANDS)) as pool:  # XLA compiles outside the GIL
        list(pool.map(jax_run, CLI_COMMANDS))
    pod.results()
    return root


@pytest.mark.parametrize("command", sorted(CLI_COMMANDS))
def test_cli_trains_data_parallel_like_the_jax_cli(cli_runs, command):
    """The port's CLI on a 2-rank gloo pod under torchrun's variables
    (``--steps 3 --train_batch_size 4``): rank 0 writes ``final/``, whose
    parameters equal the JAX CLI's data-parallel ``final/``."""
    got = _final_params(str(cli_runs / "port" / command / "final"))
    want = _final_params(str(cli_runs / "jax" / command / "final"))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(np.asarray(got[k], np.float32), np.asarray(want[k], np.float32),
                                   rtol=RTOL, atol=ATOL, err_msg=str(k))
    init = _final_params(str(cli_runs / "init" / command))
    assert any(not np.array_equal(np.asarray(got[k]), np.asarray(init[k])) for k in init)  # it trained
