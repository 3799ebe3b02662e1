"""kernels/axhelm/tune.py: the port's launch tuner — candidate bodies, the
caches and their resolution order, the sweep's bookkeeping, the resource
model — beside the reference's tests/test_axhelm_tune.py, whose ten cases
are ported here with the meaning they have for the port.

On the CPU the sweep cannot time a kernel: its bookkeeping runs on a
"fake card" (`tune._time_candidate` returns set seconds, the inputs and the
device tag are stand-ins), and the route's launches run on meta tensors
through the stand-in library of tests/test_torch_axhelm_column.py.  The
real sweep is a `cuda` test (and `chip_smoke.py` phase `tune`).
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.analysis.contracts import EntryArtifacts, ResourceBudget
from repro_torch.core import mesh_gen, nekbone
from repro_torch.core.spectral import basis as tbasis
from repro_torch.kernels.axhelm import ops, tune

from test_torch_axhelm_column import _meta, fake_card  # noqa: F401

DTYPES = (torch.float32, torch.bfloat16)
RTOL32 = 1e-4      # a tuned route against its plain version, fp32
RTOL_BF16 = 8e-3   # and bf16 storage (one bf16 ulp of the largest entry)
FAKE_TIMES = {"column": 3e-6, "line": 3e-6, "any": 5e-6, "slab": 2e-6,
              "plane": 4e-6, "staged": 9e-6}


@pytest.fixture()
def isolated_cache(tmp_path, monkeypatch):
    """Point the JSON cache at a tmp file and clear the in-process cache."""
    path = tmp_path / "axhelm_tune.json"
    monkeypatch.setenv(tune.CACHE_ENV, str(path))
    saved = dict(tune._MEM_CACHE)
    tune._MEM_CACHE.clear()
    yield path
    tune._MEM_CACHE.clear()
    tune._MEM_CACHE.update(saved)


@pytest.fixture()
def fake_sweep(monkeypatch):
    """autotune's bookkeeping without a card: the device tag of a stand-in
    card, no inputs, and FAKE_TIMES for every body timed (recorded)."""
    timed = []
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(tune, "_device_tag",
                        lambda device: "Fake H100/sm_90")
    monkeypatch.setattr(tune, "_synthetic_inputs", lambda *a: None)

    def time_candidate(body, inputs, variant, helmholtz, reps, iters):
        timed.append(body)
        return FAKE_TIMES[body]

    monkeypatch.setattr(tune, "_time_candidate", time_candidate)
    return timed


def _key(variant, n1, dtype=torch.float32, helm=False, ncols=1):
    return tune._config_key(variant, n1, dtype, helm, ncols)


# ------------------------------------------- candidates, resource model ---


@pytest.mark.parametrize("variant", ops.KERNEL_VARIANTS)
def test_candidates_respect_the_bodies_limits_and_the_budget(variant):
    """(reference: test_feasible_candidates_respect_budget) The static
    route first, then every body whose range holds N1 — tuned 2-16,
    generic to 24, slab to 24, plane to 48, staged to 878 — and every one
    fits ResourceBudget at one column."""
    tuned = "column" if variant in ops.COLUMN_VARIANTS else "line"
    assert tune.candidates(variant, 8) == (tuned, "any", "slab", "plane",
                                           "staged")
    assert tune.candidates(variant, 17) == ("slab", "any", "plane",
                                            "staged")
    assert tune.candidates(variant, 25) == ("plane", "staged")
    assert tune.candidates(variant, 48) == ("plane", "staged")
    assert tune.candidates(variant, 49) == ("staged",)
    assert tune.candidates(variant, 1) == ()
    assert tune.candidates(variant, ops.N1_STAGED_MAX + 1) == ()
    helm = variant == "merged"
    for n1 in range(2, ops.N1_STAGED_MAX + 1):
        cand = tune.candidates(variant, n1)
        assert cand[0] == ops.body_of(variant, n1)
        if n1 > ops.N1_PLANE_MAX and n1 % 37:
            continue
        for dtype in DTYPES:
            for body in cand:
                assert ResourceBudget(variant, n1, dtype, helm,
                                      body=body).check(
                    EntryArtifacts("x")) == [], (n1, body, dtype)
    # a body outside its range is over the card's shared memory
    assert ResourceBudget(variant, 40, torch.float32, helm,
                          body="any").check(EntryArtifacts("x"))


def test_resource_model_charges_fp32_scratch_at_bf16_storage():
    """(reference: test_bf16_block_charges_fp32_accumulator) The slab,
    plane and staged bodies stage in fp32 whatever the storage type, so
    their shared memory is the same at bf16; the line body's copies of x
    are in the storage type and its sums in fp32."""
    for body in ("slab", "plane", "staged"):
        f32 = tune.launch_resources(body, "trilinear", 20, torch.float32)
        bf16 = tune.launch_resources(body, "trilinear", 20, torch.bfloat16)
        assert [k.smem_bytes for k in f32] == [k.smem_bytes for k in bf16]
    (f32,) = tune.launch_resources("line", "precomputed", 8, torch.float32)
    (bf16,) = tune.launch_resources("line", "precomputed", 8,
                                    torch.bfloat16)
    assert f32.smem_bytes == ops.line_smem_bytes(8, "precomputed", 4)
    assert bf16.smem_bytes == ops.line_smem_bytes(8, "precomputed", 2)
    # only the two x buffers narrow: 2 buffers x N1 k-slabs x (N1^2 + a
    # 16-byte pad) values, 2 bytes each
    assert f32.smem_bytes - bf16.smem_bytes == \
        2 * 8 * (64 + 4) * 4 - 2 * 8 * (64 + 8) * 2
    # the staged Helmholtz last pass stages the mass and x too
    poisson = tune.launch_resources("staged", "trilinear", 64, torch.float32)
    helm = tune.launch_resources("staged", "trilinear", 64, torch.float32,
                                 helmholtz=True)
    assert helm[-1].smem_bytes - poisson[-1].smem_bytes == \
        4 * 2 * 64 * (ops.staged_lines(64) + 8)
    assert [k.min_blocks for k in helm] == [ops.STAGED_MIN_BLOCKS] * 6
    assert [k.resident for k in helm] == [1] * 6


def test_launch_resources_follow_the_sources():
    """The blocks an SM each body's `__launch_bounds__` promises, as the
    model reads them: the slab and plane passes' constants, the staged
    body's literal 4 (`ops.STAGED_MIN_BLOCKS`), one for the generic body
    and the line kernels."""
    csrc = Path(ops.__file__).parent / "csrc"
    staged = (csrc / "axhelm_staged.cu").read_text()
    assert staged.count("__launch_bounds__(kStagedThreads, "
                        f"{ops.STAGED_MIN_BLOCKS})") == 2
    assert f"kSlabMinBlocks = {ops.SLAB_MIN_BLOCKS};" in \
        (csrc / "axhelm_slab.cu").read_text()
    assert f"kPlaneMinBlocks = {ops.PLANE_MIN_BLOCKS};" in \
        (csrc / "axhelm_plane.cu").read_text()
    assert "__launch_bounds__(kAnyThreads)" in \
        (csrc / "axhelm.cu").read_text()
    blocks = {k.kernel: k.min_blocks for body in ("slab", "plane", "any")
              for k in tune.launch_resources(body, "trilinear", 20,
                                             torch.float32)}
    assert blocks == {"axhelm_slab_kernel": ops.SLAB_MIN_BLOCKS,
                      "axhelm_slab_last_kernel": 1,
                      "axhelm_plane_line_kernel<0>": 1,
                      "axhelm_plane_line_kernel<1>": 1,
                      "axhelm_plane_kernel": ops.PLANE_MIN_BLOCKS,
                      "axhelm_any_kernel": 1}
    (column,) = tune.launch_resources("column", "trilinear", 8,
                                      torch.float32)
    assert (column.threads, column.min_blocks) == (
        ops.column_threads(8), ops.COLUMN_MIN_BLOCKS)


def test_older_schema_entries_miss(isolated_cache):
    """(reference: test_v1_cache_entries_miss_under_v2_schema) An entry
    whose key carries another schema version, or no version, misses."""
    backend = tune.backend_tag("cpu")
    key = _key("trilinear", 8)
    assert key.startswith(f"{tune.SCHEMA}/")
    isolated_cache.write_text(json.dumps({backend: {
        "v0" + key[len(tune.SCHEMA):]: {"body": "slab"},
        key.split("/", 1)[1]: {"body": "slab"}}}))
    assert tune.get_body("trilinear", 8, torch.float32,
                         device="cpu") == "column"


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("variant", ops.KERNEL_VARIANTS)
def test_no_cache_resolves_every_n1_to_the_static_route(isolated_cache,
                                                        variant, dtype):
    """(reference: test_get_block_elems_heuristic_fallback) With no cache
    file, every N1 from 2 to 878 resolves to `ops.body_of`'s route, at one
    column and at four, and the miss is remembered in process."""
    helm = variant == "merged"
    for n1 in range(2, ops.N1_STAGED_MAX + 1):
        for ncols in (1, 4):
            assert tune.get_body(variant, n1, dtype, helm, ncols,
                                 device="cpu") == ops.body_of(variant, n1)
    assert not isolated_cache.exists()
    backend = tune.backend_tag("cpu")
    assert tune._MEM_CACHE[(backend, _key(variant, 20, dtype, helm))] \
        == tune._STATIC


def test_autotune_sweeps_caches_and_reuses(isolated_cache, fake_sweep):
    winner, timings = tune.autotune("trilinear", 19, e=8, iters=1)
    assert fake_sweep == ["slab", "any", "plane", "staged"]
    assert set(timings) == {"slab", "any", "plane", "staged"}
    assert winner == "slab" and all(t > 0 for t in timings.values())
    # JSON cache written, keyed by the card and the sources' digest
    data = json.loads(isolated_cache.read_text())
    backend = tune.backend_tag("cuda")
    assert backend.startswith("Fake H100/sm_90/")
    assert data[backend][_key("trilinear", 20)]["body"] == winner
    assert data[backend][_key("trilinear", 20)]["timings_s"] == timings
    # in-process cache hit
    assert tune.get_body("trilinear", 20, torch.float32,
                         device="cuda") == winner
    # cold process (mem cache cleared) falls back to the JSON entry
    tune.clear()
    assert tune.get_body("trilinear", 20, torch.float32,
                         device="cuda") == winner
    # another dtype, Helmholtz or column count is another configuration
    assert tune.get_body("trilinear", 20, torch.bfloat16,
                         device="cuda") == "slab"
    assert _key("trilinear", 20, ncols=4) not in data[backend]
    # above N1_PLANE_MAX there is nothing to sweep: no lookup, no file read
    isolated_cache.write_text("not json")
    assert tune.get_body("trilinear", 64, torch.float32,
                         device="cuda") == "staged"


def test_cached_body_that_cannot_run_the_configuration_is_a_miss(
        isolated_cache):
    """(reference: test_cached_winner_clamped_to_shard_elems) The port has
    no element clamp — every body takes any E — so the counterpart is a
    cached body the configuration cannot take: it warns and misses."""
    backend = tune.backend_tag("cpu")
    isolated_cache.write_text(json.dumps({backend: {
        _key("trilinear", 30): {"body": "slab"},
        _key("trilinear", 20): {"body": "line"},
        _key("trilinear", 8): {"body": "plane"}}}))
    with pytest.warns(RuntimeWarning, match="malformed"):
        assert tune.get_body("trilinear", 30, torch.float32,
                             device="cpu") == "plane"
    with pytest.warns(RuntimeWarning, match="malformed"):
        assert tune.get_body("trilinear", 20, torch.float32,
                             device="cpu") == "slab"
    assert tune.get_body("trilinear", 8, torch.float32,
                         device="cpu") == "plane"


def test_launch_auto_entry_point(isolated_cache, rng):
    """(reference: test_block_elems_auto_entry_point) On a CPU tensor the
    plain version runs whatever `launch` says; an unknown value raises, in
    `ops.axhelm` and in `setup_problem`; `autotune` refuses the CPU."""
    b = tbasis(2)
    verts = torch.as_tensor(mesh_gen.deform_trilinear(
        mesh_gen.box_mesh(2, 2, 1, 2), seed=3).verts, dtype=torch.float32)
    x = torch.as_tensor(rng.standard_normal((4, 3, 3, 3)),
                        dtype=torch.float32)
    y = ops.axhelm(x, b, "trilinear", verts, launch="auto")
    assert torch.equal(y, ops.reference(x, b, "trilinear", verts))
    assert not tune._MEM_CACHE and not isolated_cache.exists()
    with pytest.raises(ValueError, match="launch"):
        ops.axhelm(x, b, "trilinear", verts, launch="fastest")
    mesh = mesh_gen.box_mesh(2, 2, 1, 2)
    with pytest.raises(ValueError, match="launch"):
        nekbone.setup_problem(mesh, device="cpu", launch="fastest")
    prob = nekbone.setup_problem(mesh, device="cpu", launch="auto")
    assert prob.backend == "reference" and not tune._MEM_CACHE
    with pytest.raises(ValueError, match="card"):
        tune.autotune("trilinear", 2, device="cpu")


def test_corrupt_cache_file_warns_and_degrades_to_miss(isolated_cache):
    """A truncated cache (a process killed mid-write) warns and falls
    through to the static route — never raises into a solve."""
    isolated_cache.write_text('{"cpu/abc": {"v1/tri')
    with pytest.warns(RuntimeWarning, match="corrupt"):
        assert tune.get_body("trilinear", 20, torch.float32,
                             device="cpu") == "slab"


def test_non_mapping_cache_warns_and_is_ignored(isolated_cache):
    isolated_cache.write_text("[1, 2, 3]")
    with pytest.warns(RuntimeWarning, match="mapping"):
        assert tune._load_json() == {}


def test_malformed_entry_is_a_miss_and_retune_heals(isolated_cache,
                                                    fake_sweep):
    """Valid JSON with a garbage entry: a miss; the next tuning run
    overwrites the wreck atomically (no tmp litter)."""
    backend = tune.backend_tag("cuda")
    key = _key("trilinear", 20)
    isolated_cache.write_text(json.dumps({backend: {key: {"body": 7}}}))
    with pytest.warns(RuntimeWarning, match="malformed"):
        assert tune._cache_entry(backend, key, "trilinear", 20) is None
    winner, _ = tune.autotune("trilinear", 19, bodies=["plane", "staged"])
    assert winner == "plane"
    data = json.loads(isolated_cache.read_text())
    assert data[backend][key]["body"] == "plane"
    assert not list(isolated_cache.parent.glob("*.tmp.*"))


def test_read_only_cache_directory_never_breaks_a_tune(tmp_path,
                                                       monkeypatch,
                                                       isolated_cache,
                                                       fake_sweep):
    """The write fails silently; the winner still holds in process."""
    monkeypatch.setenv(tune.CACHE_ENV, str(tmp_path / "file" / "x.json"))
    (tmp_path / "file").write_text("a file, not a directory")
    winner, _ = tune.autotune("merged", 30)
    assert tune.get_body("merged", 31, torch.float32, True,
                         device="cuda") == winner == "plane"


# --------------------------------------------------------- the route ---


@pytest.mark.parametrize("variant", ops.KERNEL_VARIANTS)
def test_tuned_route_launches_and_counts_as_the_entry_point(
        fake_card, isolated_cache, variant):
    """A tuned route runs its body's symbol and counts one launch of the
    entry point (not a twin's); the static route runs where no cache
    holds the configuration, and `clear` brings it back."""
    b = tbasis(7)
    e, helm = 5, variant == "merged"
    geom = _meta({"precomputed": (e, 7, 8, 8, 8),
                  "parallelepiped": (e, 7)}.get(variant, (e, 8, 3)))
    lams = {"merged": ("lam0", "lam1"), "partial": ("lam0",)}.get(variant,
                                                                   ())
    kw = {name: _meta((e, 8, 8, 8)) for name in lams}
    x = _meta((e, 8, 8, 8))
    name = ops.entry_point(variant, torch.float32)
    tune._MEM_CACHE[(tune.backend_tag("meta"),
                     _key(variant, 8, helm=helm))] = "slab"
    before = ops.launch_counts[name]
    ops.axhelm(x, b, variant, geom, helmholtz=helm, **kw)
    tune.clear()
    ops.axhelm(x, b, variant, geom, helmholtz=helm, **kw)
    (tuned, _), (static, _) = fake_card.calls
    assert tuned == f"{name}_slab" and static == name
    assert ops.launch_counts[name] == before + 2


# ------------------------------------------------------------ on a card ---


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_autotune_on_the_card_and_the_tuned_route(card, isolated_cache,
                                                  dtype):
    """The sweep times every candidate at N1 = 20 on the card, writes the
    winner, a fresh process cache resolves it from the file, and
    `ops.axhelm` through the tuned route matches the plain version (1e-4
    fp32, 8e-3 bf16, relative to the largest entry) and counts one
    entry-point launch."""
    winner, timings = tune.autotune("trilinear", 19, dtype=dtype, e=27)
    assert set(timings) == set(tune.candidates("trilinear", 20))
    tune.clear()
    assert tune.get_body("trilinear", 20, dtype, device=card) == winner
    rng = np.random.default_rng(0)
    b = tbasis(19)
    verts = torch.as_tensor(mesh_gen.deform_trilinear(
        mesh_gen.box_mesh(3, 3, 3, 19), seed=3).verts, device=card)
    x = torch.as_tensor(rng.standard_normal((27, 20, 20, 20)),
                        dtype=torch.float32, device=card).to(dtype)
    verts = verts.to(dtype)
    name = ops.entry_point("trilinear", dtype)
    before = ops.launch_counts[name]
    y = ops.axhelm(x, b, "trilinear", verts).float()
    y_p = ops.reference(x, b, "trilinear", verts).float()
    rel = float((y - y_p).abs().max() / y_p.abs().max())
    assert rel <= (RTOL32 if dtype == torch.float32 else RTOL_BF16), rel
    assert ops.launch_counts[name] == before + 1
