"""The port's streaming walkthrough
(``fusion_tpu_torch/examples/streaming_serving.py``) against the JAX
package's (``examples/streaming_serving.py``), on the CPU.

The JAX example runs once, unedited, with its dense model captured and its
printed answers read back; the port's runs on that model's weights
converted (``models/convert.py``).  Each HTTP answer (before the add, after
the add of 10 docs, after the delete of the top hit, after ``compact``) is
held to JAX's: ids equal except within ties, scores (rounded by the server
to 6 decimals) within 2e-6; the build, health and stats lines equal."""

import ast
import contextlib
import io
import os
import runpy

import numpy as np
import pytest
import torch
from torch_parity import DEVICE, assert_ranked_match

from fusion_tpu_torch.examples import streaming_serving
from fusion_tpu_torch.models import convert
from fusion_tpu_torch.models.biencoder import BiEncoder
from fusion_tpu_torch.models.encoder import EncoderConfig

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS = ("before_add", "after_add", "after_delete", "after_compact")


@pytest.fixture(scope="module")
def runs():
    import fusion_tpu.models.biencoder as jbiencoder

    kept = {}

    class Recording(jbiencoder.BiEncoder):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            kept["dense"] = self

    mp = pytest.MonkeyPatch()
    mp.setattr(jbiencoder, "BiEncoder", Recording)
    out = io.StringIO()
    try:
        with contextlib.redirect_stdout(out):
            runpy.run_path(os.path.join(REPO, "examples", "streaming_serving.py"), run_name="__main__")
    finally:
        mp.undo()
    want = out.getvalue().splitlines()

    dense = BiEncoder(EncoderConfig.tiny(vocab_size=1024), params=convert.encoder_state_dict(kept["dense"].params),
                      head="dense", max_query_length=8, max_doc_length=16, device=DEVICE)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        got = streaming_serving.main(DEVICE, models={"dense": dense})
    return want, got, out.getvalue().splitlines()


def _answer(line):
    return ast.literal_eval(line.split(": ", 1)[1])


@pytest.mark.parametrize("step", STEPS)
def test_each_answer_matches_jax(runs, step):
    want_lines, got, _ = runs
    want = _answer(want_lines[1 + STEPS.index(step)])
    answer = got["answers"][step]
    assert len(answer["ids"]) == len(want["ids"]) == 3
    assert_ranked_match(np.array([answer["ids"]]), np.array([answer["scores"]]), np.array([want["ids"]]),
                        np.array([want["scores"]]), atol=2e-6)


def test_prints_the_lines_of_the_jax_example(runs):
    want, got, lines = runs
    assert len(lines) == len(want) == 7
    for i in (0, 5, 6):
        assert lines[i] == want[i]
    for i in range(1, 5):
        assert lines[i].split(": ", 1)[0] == want[i].split(": ", 1)[0]
    assert got["healthz"] == _answer(want[5])
    assert got["stats"]["requests"] == got["stats"]["batches"] == 4


def test_needs_the_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        streaming_serving.main()
    assert streaming_serving.parse_args(["--device", "cpu"]).device == "cpu"
