"""The sharded solve on the card: two gloo ranks on one CUDA device
(`--dist-backend gloo` of the CLI), the hand-written kernels in every
operator application, against the single-device kernel solve (psum
exchange) and against the psum solve (neighbour exchange, its rounds
staged through pinned host memory): the same status, iterations within
+-1, dx < 1e-3, and the same x on both ranks.

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


def test_neighbour_solve_on_the_card(card):
    """The neighbour exchange on the card over gloo (host-staged): within
    +-1 iteration of the psum solve, the same status, dx < 1e-3; the
    refined solve CONVERGED on every wire with true residual <= 1.5 tol,
    the bf16 wire bitwise the uncompressed one; the same x on both
    ranks."""
    per_rank = spawn(ranks.card_neighbour_rows, 2, backend="gloo",
                     timeout_s=300)
    rows = per_rank[0]
    solves, refined = rows[:2], rows[2:]
    assert [r["variant"] for r in solves] == ["trilinear", "merged"]
    assert all(r["split"] for r in solves)
    for r in solves:
        assert r["status"] == [0, 0], r
        assert abs(r["iterations"][0] - r["iterations"][1]) <= 1, r
        assert r["dx"] < 1e-3, r
    assert [r["wire"] for r in refined] == [None, "bf16", "int8"]
    for r in refined:
        assert r["status"] == [0], r
        assert r["true"] <= 1.5 * 0.03, r
    assert refined[1]["iterations"] == refined[0]["iterations"]
    assert refined[1]["x_digest"] == refined[0]["x_digest"]
    assert [r["x_digest"] for r in per_rank[1]] == \
        [r["x_digest"] for r in rows]
