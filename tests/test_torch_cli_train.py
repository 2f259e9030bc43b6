"""The port's training commands (``dpr``, ``splade``, ``colbert``,
``monobert``) on the CPU at ``--tiny``, on the fixture of
``test_torch_cli.py``: each trains (3 steps, batch 2) into ``final/``, and
then its ``test`` task runs in both packages on that checkpoint, whose
metric files must agree; the JAX package loads each ``final/`` and
encodes as the port does; ColBERT's ``index`` and ``search`` tasks, the
``--seeds`` reruns and the options that raise.

Tolerances: metrics within 1e-6 (the same ranks from f32 scores that
differ in the last digits); encodings within 1e-5 (as
``test_torch_encoder.py``)."""

import csv
import json
import os
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_cli import _fixture
from torch_parity import DEVICE

from fusion_tpu.cli.main import main as jax_main
from fusion_tpu.models.biencoder import BiEncoder as JaxBiEncoder
from fusion_tpu.models.colbert import ColBERT as JaxColBERT
from fusion_tpu.models.crossencoder import CrossEncoder as JaxCrossEncoder
from fusion_tpu.models.t5 import T5CrossEncoder as JaxT5CrossEncoder
from fusion_tpu_torch.cli.main import main
from fusion_tpu_torch.models.biencoder import BiEncoder
from fusion_tpu_torch.models.colbert import ColBERT
from fusion_tpu_torch.models.crossencoder import CrossEncoder
from fusion_tpu_torch.models.encoder import token_tensors
from fusion_tpu_torch.models.t5 import T5CrossEncoder

COMMANDS = ("dpr", "splade", "colbert", "monobert")
TRAIN = ["--task", "train", "--steps", "3", "--train_batch_size", "2"]
METRIC_FILES = {"dpr": "ir_eval_results.csv", "splade": "ir_eval_results.csv",
                "colbert": "performance_colbert.json", "monobert": "rerank_eval_results.csv"}
TEXTS = ["chat chien tribunal", "contrat de travail et loi", "", "forêt route oiseau jardin souris"]


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli_train")
    fx = root / "fixture.json"
    fx.write_text(json.dumps(_fixture()))
    for cmd in COMMANDS:
        main([cmd, *TRAIN, "--fixture", str(fx), "--output_dir", str(root / cmd), "--tiny", "--device", DEVICE])
    return root, str(fx)


def _metrics(path):
    if path.endswith(".json"):
        with open(path) as f:
            return json.load(f)
    with open(path) as f:
        row = list(csv.DictReader(f))[-1]
    return {k: float(v) for k, v in row.items() if "ms/query" not in k}


@pytest.mark.parametrize("cmd", COMMANDS)
def test_test_task_on_the_trained_model_matches_jax(trained, cmd):
    root, fx = trained
    final = str(root / cmd / "final")
    assert os.path.isfile(os.path.join(final, "params.msgpack"))
    out = {}
    for pkg, run in (("jax", jax_main), ("port", main)):
        out_dir = str(root / f"test_{pkg}" / cmd)
        os.makedirs(out_dir)  # the JAX colbert test task writes into it without making it
        extra = ["--device", DEVICE] if pkg == "port" else []
        run([cmd, "--task", "test", "--model_path", final, "--fixture", fx, "--output_dir", out_dir, "--tiny", *extra])
        out[pkg] = _metrics(os.path.join(out_dir, METRIC_FILES[cmd]))
    assert sorted(out["port"]) == sorted(out["jax"])
    for k, v in out["jax"].items():
        assert abs(out["port"][k] - v) <= 1e-6, (k, out["port"][k], v)


@pytest.mark.parametrize("cmd", COMMANDS)
def test_jax_loads_the_port_final(trained, cmd):
    final = str(trained[0] / cmd / "final")
    if cmd == "monobert":
        jm, tm = JaxCrossEncoder.load(final), CrossEncoder.load(final, device=DEVICE)
        pairs = [(t, TEXTS[-1]) for t in TEXTS]
        np.testing.assert_allclose(tm.predict(pairs, apply_sigmoid=False), jm.predict(pairs, apply_sigmoid=False),
                                   atol=1e-5)
        return
    if cmd == "colbert":
        jm, tm = JaxColBERT.load(final), ColBERT.load(final, device=DEVICE)
    else:
        jm, tm = JaxBiEncoder.load(final), BiEncoder.load(final, device=DEVICE)
    ids, mask = tm.text_encoder.encode(TEXTS, query_mode=True)
    want = np.asarray(jm.embed_tokens(jm.params, jnp.asarray(ids), jnp.asarray(mask)))
    got = tm.embed_tokens(*token_tensors(ids, mask, DEVICE)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_colbert_index_and_search_match_jax(trained):
    root, fx = trained
    final = str(root / "colbert" / "final")
    port_dir, jax_dir = root / "cb_port", root / "cb_jax"
    base = ["--model_path", final, "--fixture", fx, "--tiny"]
    main(["colbert", "--task", "index", *base, "--output_dir", str(port_dir), "--device", DEVICE])
    assert os.path.isfile(port_dir / "index" / "token_index.npz")
    shutil.copytree(port_dir / "index", jax_dir / "index")  # the JAX package searches the port's index
    main(["colbert", "--task", "search", *base, "--output_dir", str(port_dir), "--device", DEVICE])
    jax_main(["colbert", "--task", "search", *base, "--output_dir", str(jax_dir)])
    got, want = (json.load(open(d / "ranking.json")) for d in (port_dir, jax_dir))
    assert sorted(got) == sorted(want)
    for q in want:
        assert got[q][:10] == want[q][:10], q


def test_seeds_rerun_into_their_own_directories(trained):
    root, fx = trained
    out = root / "seeds"
    main(["dpr", *TRAIN, "--seeds", "5,6", "--fixture", fx, "--output_dir", str(out), "--tiny", "--device", DEVICE])
    finals = [BiEncoder.load(str(out / f"seed{s}" / "final"), device=DEVICE) for s in (5, 6)]
    a, b = (dict(m.module.named_parameters())["embeddings.word.weight"] for m in finals)
    assert not torch.equal(a, b)


def test_freeze_and_optimizer_flags(trained):
    root, fx = trained
    out = root / "frozen"
    main(["splade", *TRAIN, "--freeze_layers_except_last_n", "1", "--optimizer", "Adafactor", "--fixture", fx,
          "--output_dir", str(out), "--tiny", "--device", DEVICE])
    init = BiEncoder(BiEncoder.load(str(out / "final"), device=DEVICE).cfg, head="splade", seed=42, device=DEVICE)
    trained_sd = BiEncoder.load(str(out / "final"), device=DEVICE).module.state_dict()
    for k, v in init.module.state_dict().items():
        frozen = k.startswith(("encoder.embeddings.", "encoder.layers.0."))
        assert torch.equal(trained_sd[k], v) == frozen, k


# the ids name each case's option (both raised until their ports landed)
@pytest.mark.parametrize("argv", [
    ["monobert", "--task", "train", "--backbone", "t5"],
    ["dpr", "--task", "train", "--attention_impl", "flash"],
], ids=["argv0-backbone_t5", "argv1-attention_impl_flash"])
def test_unported_options_raise(trained, argv):
    """Both train now: the T5 backbone into a ``t5_crossencoder`` final/ that
    the JAX package scores as the port does; ``--attention_impl`` left at the
    tiny config's form by ``--tiny`` (as the JAX CLI leaves it), the final/
    saying so and encoding in JAX as in the port."""
    root, fx = trained
    out = root / f"option_{argv[0]}"
    main(argv + TRAIN[2:] + ["--fixture", fx, "--output_dir", str(out), "--tiny", "--device", DEVICE])
    final = str(out / "final")
    with open(os.path.join(final, "config_fusion_tpu.json")) as f:
        config = json.load(f)
    if argv[0] == "monobert":
        assert config["model_type"] == "t5_crossencoder"
        pairs = [(t, TEXTS[-1]) for t in TEXTS]
        np.testing.assert_allclose(T5CrossEncoder.load(final, device=DEVICE).predict(pairs, apply_sigmoid=False),
                                   JaxT5CrossEncoder.load(final).predict(pairs, apply_sigmoid=False), atol=1e-5)
        return
    assert config["encoder"]["attention_impl"] == "einsum"
    jm, tm = JaxBiEncoder.load(final), BiEncoder.load(final, device=DEVICE)
    ids, mask = tm.text_encoder.encode(TEXTS, query_mode=True)
    np.testing.assert_allclose(tm.embed_tokens(*token_tensors(ids, mask, DEVICE)).numpy(),
                               np.asarray(jm.embed_tokens(jm.params, jnp.asarray(ids), jnp.asarray(mask))), atol=1e-5)


def test_training_needs_the_card_unless_asked_for_the_cpu(trained, monkeypatch):
    """Without a card a training command raises unless given ``--device
    cpu``, data-parallel or not; with several cards a plain process spawns
    one rank per card it uses (here the spawn is recorded, not run)."""
    from fusion_tpu_torch.cli import main as cli_main

    root, fx = trained
    base = ["--fixture", fx, "--output_dir", str(root / "nocard"), "--tiny"]
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    if not torch.cuda.is_available():
        for argv in (["colbert", *TRAIN, *base], ["dpr", *TRAIN, "--no_data_parallel", *base]):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                main(argv)
    spawned = []
    monkeypatch.setattr(cli_main, "resolve_device", torch.device)
    monkeypatch.setattr(cli_main, "_spawn_ranks", lambda argv, ranks: spawned.append((argv, ranks)))
    assert main(["colbert", *TRAIN, *base]) is None
    assert spawned == [(["colbert", *TRAIN, *base], 2)]
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 3)  # batch 2 over 3 cards: 2 ranks
    main(["monobert", *TRAIN, *base])
    assert spawned[-1] == (["monobert", *TRAIN, *base], 2)


def test_training_modules_leave_jax_out():
    """The trainer, optimizers, losses, evaluators and utilities import
    neither JAX, flax, optax nor the JAX package."""
    import subprocess
    import sys

    code = (
        "import sys; import fusion_tpu_torch.train.trainer, fusion_tpu_torch.eval.evaluators, "
        "fusion_tpu_torch.utils.common, fusion_tpu_torch.data.lleqa; "
        "print(sorted(m for m in ('jax', 'flax', 'optax', 'fusion_tpu') if m in sys.modules))"
    )
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, check=True, cwd=repo)
    assert out.stdout.strip() == "[]"
