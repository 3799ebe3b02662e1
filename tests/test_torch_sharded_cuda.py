"""The sharded solve on the card: two gloo ranks on one CUDA device
(`--dist-backend gloo` of the CLI), the hand-written kernels in every
operator application, against the single-device kernel solve: the same
status, iterations within +-1, dx < 1e-3, and the same x on both ranks.

Every test carries the `cuda` marker and skips without a card, decided in
the `card` fixture at run time.  Run on the card:
``python -m pytest -q -m cuda tests/test_torch_sharded_cuda.py``.
"""

import pytest
import torch

import _torch_sharded_ranks as ranks
from repro_torch.distributed.launch import spawn
from repro_torch.kernels.axhelm import build

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    build.build()               # once here, not in every rank


def test_sharded_solve_on_the_card(card):
    per_rank = spawn(ranks.card_rows, 2, backend="gloo", timeout_s=300)
    rows = per_rank[0]
    assert [r["variant"] for r in rows] == ["trilinear", "merged"]
    for r in rows:
        assert r["backend"] == "cuda", r
        assert r["status"][0] == r["status"][1] == 0, r
        assert abs(r["iterations"][0] - r["iterations"][1]) <= 1, r
        assert r["dx"] < 1e-3, r
    assert [r["x_digest"] for r in per_rank[1]] == \
        [r["x_digest"] for r in rows]
