"""Port parity at head dims above 512: the plain versions of K1, K2 and K3
against the JAX Pallas kernels in interpret mode, the routing of CUDA
tensors (bf16 and f32 to the streamed kernels of csrc/flash_wide.cu), the
streamed kernels' column groups in both dtypes, and a Llama at head_dim
576 against the JAX model.

On the CPU the port runs ``flash_fwd_reference`` and
``flash_bwd_dq_reference``/``flash_bwd_dkv_reference`` at every head dim;
the streamed kernels run only on the card (chip_smoke.py and
tests/test_torch_cuda.py). Tolerances are those of the wide cases in
tests/test_torch_flash.py (the d 64 cases' of the same kind).
"""

import dataclasses
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from service_account_auth_improvements_tpu.models import llama as jllama  # noqa: E402
from service_account_auth_improvements_tpu.ops import (  # noqa: E402
    flash_attention as jfa,
)
from service_account_auth_improvements_tpu.train import step as jstep  # noqa: E402
from service_account_auth_improvements_tpu_torch.models import (  # noqa: E402
    llama as tllama,
    params as tparams,
)
from service_account_auth_improvements_tpu_torch.ops import (  # noqa: E402
    flash_attention as tfa,
)
from service_account_auth_improvements_tpu_torch.train import (  # noqa: E402
    step as tstep,
)

SOURCE = (Path(tfa.__file__).resolve().parent.parent / "csrc"
          / "flash_wide.cu")
KERNELS = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
# the head dims the parity cases run at (the plain versions in f32): the
# first past 512, one that is no multiple of the group width,
# bench_800m_d768's, and four whole groups
PARITY_DIMS = (576, 640, 768, 1024)
# the routing and the column groups: the parity dims, the two prime
# multiples of 64 among them (11 and 13 chunks), and two more groups
ROUTED_DIMS = (576, 640, 704, 768, 832, 1024, 2048)


@pytest.fixture
def counter():
    tfa.launches = tfa.dq_launches = tfa.dkv_launches = 0
    yield
    assert (tfa.launches, tfa.dq_launches, tfa.dkv_launches) == (0, 0, 0), \
        "no kernel may launch for CPU tensors"


def _heads(d, seed):
    """q, k, v and dO, [b 1, heads, s 256, d], 2 / 1 heads, seeded."""
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((1, n, 256, d)).astype(np.float32)
            for n in (2, 1, 1, 2)]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", PARITY_DIMS)
def test_forward_reference_matches_jax_kernel(d, causal, counter,
                                              monkeypatch):
    """K1's plain version: O and LSE against ``_flash_fwd(...,
    interpret=True)``, two blocks of 128 per axis, GQA group 2."""
    monkeypatch.setattr(jfa, "_pick_block", lambda seq, want: 128)
    q, k, v, _ = _heads(d, seed=d)
    jo, jlse = jfa._flash_fwd(*(jnp.asarray(a) for a in (q, k, v)),
                              causal=causal, interpret=True)
    o, lse = tfa.flash_fwd_reference(*(torch.tensor(a) for a in (q, k, v)),
                                     causal)
    assert o.shape == (1, 2, 256, d) and lse.shape == (1, 2, 256)
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), atol=2e-5)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse)[..., 0],
                               atol=1e-5)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", PARITY_DIMS)
def test_backward_reference_matches_jax_kernels(d, causal, counter,
                                                monkeypatch):
    """K2's and K3's plain versions (through ``flash_bwd``, the CPU
    route): dQ, dK and dV against ``_flash_bwd(..., interpret=True)`` on
    the JAX forward's O and LSE."""
    monkeypatch.setattr(jfa, "_pick_block", lambda seq, want: 128)
    q, k, v, do = _heads(d, seed=d + 1)
    jo, jlse = jfa._flash_fwd(*(jnp.asarray(a) for a in (q, k, v)),
                              causal=causal, interpret=True)
    want = jfa._flash_bwd(*(jnp.asarray(a) for a in (q, k, v)), jo, jlse,
                          jnp.asarray(do), causal=causal, interpret=True)
    got = tfa.flash_bwd(*(torch.tensor(a) for a in (q, k, v)),
                        torch.tensor(np.asarray(jo)),
                        torch.tensor(np.asarray(jlse)[..., 0]),
                        torch.tensor(do), causal)
    for w, g, n in zip(want, got, "qkv"):
        assert g.shape == w.shape and g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=2e-5,
                                   err_msg=f"d{n}")


@pytest.mark.parametrize("d", ROUTED_DIMS)
def test_bf16_above_512_takes_the_streamed_kernels(d):
    """Every multiple of 64 above 512 goes to csrc/flash_wide.cu, one C
    function per kernel, in bf16 and in f32 alike (the C function picks
    the dtype's kernel)."""
    assert d % 64 == 0 and d > tfa.KERNEL_HEAD_DIMS[-1]
    for name in KERNELS:
        for dtype in (torch.bfloat16, torch.float32):
            assert tfa.kernel_route(name, d, dtype) == (
                "flash_wide", tfa.WIDE_FUNCTIONS[name])


def test_route_keeps_the_per_dim_kernels_and_refuses_the_rest():
    """Head dims up to 512 keep their per-dim libraries in both dtypes;
    a head dim that is no multiple of 64 raises in both."""
    libs = {"flash_fwd": "flash_fwd", "flash_bwd_dq": "flash_bwd",
            "flash_bwd_dkv": "flash_bwd"}
    assert tfa.KERNEL_HEAD_DIMS == tuple(range(64, 513, 64))
    for d in tfa.KERNEL_HEAD_DIMS:
        for dtype in (torch.bfloat16, torch.float32):
            for name in KERNELS:
                assert tfa.kernel_route(name, d, dtype) == (libs[name], name)
    for d in (96, 600, 1000):
        for dtype in (torch.bfloat16, torch.float32):
            with pytest.raises(ValueError, match="supports head_dim"):
                tfa.kernel_route("flash_fwd", d, dtype)
    assert set(tfa.WIDE_FUNCTIONS) == set(KERNELS)
    for fn in tfa.WIDE_FUNCTIONS.values():
        assert re.search(rf'extern "C" int {fn}\(', SOURCE.read_text())


@pytest.mark.parametrize("d", ROUTED_DIMS)
def test_column_groups_cover_the_head_dim(d):
    """ceil(d / W) groups of W columns, the last one ending at d (64
    columns at d 576, 704 and 832), tile [0, d) in order; W is the
    source's constant for each kernel."""
    text = SOURCE.read_text()
    for name, const in zip(KERNELS, ("FWD_W", "DQ_W", "DKV_W")):
        w = tfa.WIDE_COLUMNS[name]
        assert re.search(rf"constexpr int {const} = {w};", text)
        groups = tfa.wide_groups(d, name)
        assert len(groups) == -(-d // w)
        assert [c for c, _ in groups] == list(range(0, d, w))
        assert sum(width for _, width in groups) == d
        assert all(width == w for _, width in groups[:-1])
        assert 0 < groups[-1][1] <= w and groups[-1][1] % 64 == 0
    assert tfa.wide_groups(576, "flash_fwd")[-1] == (512, 64)
    assert tfa.wide_groups(768, "flash_fwd") == [(0, 256), (256, 256),
                                                 (512, 256)]


@pytest.mark.parametrize("d", ROUTED_DIMS)
def test_f32_column_groups_are_the_sources(d):
    """The f32 kernels' groups: the source's FWD_W_F32, DQ_W_F32 and
    DKV_W_F32, which flash_wide_columns reports after bf16's three, are
    WIDE_COLUMNS, so ``wide_groups`` covers f32's blocks too: ceil(d / W)
    groups tiling [0, d), each a whole number of the f32 kernels'
    32-column chunks."""
    text = SOURCE.read_text()
    chunk = int(re.search(r"constexpr int F32_C = (\d+);", text).group(1))
    for name, const in zip(KERNELS, ("FWD_W_F32", "DQ_W_F32", "DKV_W_F32")):
        w = tfa.WIDE_COLUMNS[name]
        assert re.search(rf"constexpr int {const} = {w};", text)
        groups = tfa.wide_groups(d, name)
        assert len(groups) == -(-d // w)
        assert [c for c, _ in groups] == list(range(0, d, w))
        assert sum(width for _, width in groups) == d
        assert all(c % chunk == 0 and width % chunk == 0
                   for c, width in groups)
    body = text.split('extern "C" int flash_wide_columns(int kernel) {')[1]
    body = body[:body.index("\n}\n")]
    assert re.search(r"\{FWD_W, DQ_W, DKV_W, FWD_W_F32, DQ_W_F32, "
                     r"DKV_W_F32\}", body)


def test_entry_points_take_f32():
    """The C side takes f32: ``shape_ok`` refuses no dtype (f32 only below
    the ring's least head dim, under 576), and each ``extern "C"`` entry
    picks its kernel by ``bf16_in``, bf16's run or the f32 kernel's, never
    by catching an error; the wide library answers the workspace query
    the wrapper makes for f32 inputs (no split: 0 bytes)."""
    text = SOURCE.read_text()
    ok = text.split("bool shape_ok(")[1]
    ok = ok[:ok.index("\n}\n")]
    assert "return bf16_in &&" not in ok
    assert "(bf16_in || d >= F32_MIN_D)" in ok
    least = re.search(r"constexpr int F32_MIN_D = ([^;]*);", text).group(1)
    consts = {n: int(v) for n, v in re.findall(
        r"constexpr int (F32_\w+) = (\d+);", text)}
    assert eval(least, {}, consts) <= 576
    for fn, bf16_run, f32_run in (
            ("flash_wide_fwd", "run_fwd(", "run_fwd_f32("),
            ("flash_wide_dq", "run_dq(", "run_bwd_f32(false,"),
            ("flash_wide_dkv", "run_dkv(", "run_bwd_f32(true,")):
        body = text.split(f'extern "C" int {fn}(')[1]
        body = body[:body.index("\n}\n")]
        assert "shape_ok(bf16_in," in body
        assert re.search(rf"bf16_in \? {re.escape(bf16_run)}.*: "
                         rf"{re.escape(f32_run)}", body, re.S)
    for kernel in ("flash_fwd_wide_f32", "dq_wide_f32", "dkv_wide_f32"):
        assert re.search(rf"__global__ void __launch_bounds__\(F32_THREADS, "
                         rf"1\)\n{kernel}\(", text)
    assert re.search(r'extern "C" int64_t flash_wide_workspace\(', text)


def test_f32_workspace_is_asked_of_the_routed_library(monkeypatch):
    """``_launch_bwd`` asks for the f32 workspace of the library
    ``kernel_route`` names (``<lib>_workspace``), so the query and the
    launch cannot disagree: above 512 ``flash_wide``, up to it
    ``flash_bwd``."""
    asked = []

    def library(lib, fn_name, argtypes, restype=None):
        asked.append((lib, fn_name))
        return lambda *args: 0  # 0 bytes of workspace, or launched

    monkeypatch.setattr(tfa, "_library", library)
    monkeypatch.setattr(tfa, "_check_layout", lambda *args: None)
    monkeypatch.setattr(tfa.torch.cuda, "device",
                        lambda dev: __import__("contextlib").nullcontext())
    monkeypatch.setattr(tfa.torch.cuda, "current_stream",
                        lambda dev: type("S", (), {"cuda_stream": 0})())
    for d, lib in ((768, "flash_wide"), (512, "flash_bwd")):
        q = torch.zeros((1, 2, 8, d))
        lse = torch.zeros((1, 2, 8))
        asked.clear()
        tfa._launch_bwd("flash_bwd_dkv", q, q[:, :1], q[:, :1], q, lse, lse,
                        None, q[:, :1].clone(), q[:, :1].clone(), True)
        assert (lib, f"{lib}_workspace") in asked


# a Llama at head_dim 576: the "tiny" preset's width and depth with 2 / 1
# heads of 576 (the JAX package has no preset past 256); f32
HD576 = dataclasses.replace(jllama.PRESETS["tiny"], dtype="float32",
                            head_dim=576, n_heads=2, n_kv_heads=1,
                            attn_impl="flash")


def _port(cfg):
    return tllama.LlamaConfig(**dataclasses.asdict(cfg))


def _numpy(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def test_llama_head_dim_576_matches_jax(counter):
    """From one JAX init, weights and zero moments carried by
    ``models/params.py``: ``apply``'s f32 logits, the port's flash route
    (the plain K1 on the CPU) against the JAX model (dense attention on
    the CPU), within summation order; then one f32 train step (K1, K2 and
    K3's plain versions): loss, grad norm, params and Adam moments at
    tests/test_torch_train.py's f32 tolerances."""
    jopt, topt = jstep.make_optimizer(), tstep.make_optimizer()
    js = jstep.init_train_state(HD576, jax.random.key(0), optimizer=jopt)
    adam = js.opt_state[1][0]
    tree = _numpy(js.params)
    assert tree["layers"]["wq"].shape[-1] == 2 * 576
    tokens = np.random.default_rng(0).integers(
        0, HD576.vocab_size, (2, 24)).astype(np.int32)
    want = np.asarray(jllama.apply(HD576, jax.tree.map(np.asarray, tree),
                                   tokens))
    got = tllama.apply(_port(HD576), tparams.from_numpy(tree, HD576, "cpu"),
                       torch.tensor(tokens, dtype=torch.long))
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=0)

    ts = tparams.train_state_from_numpy(
        _port(HD576), tree, _numpy(adam.mu), _numpy(adam.nu), device="cpu")
    toks = np.random.default_rng(1).integers(
        4, HD576.vocab_size, (4, 40)).astype(np.int32)
    mask = np.ones_like(toks)
    js, jm = jstep.make_train_step(HD576, jopt)(js, jnp.asarray(toks),
                                                jnp.asarray(mask))
    ts, tm = tstep.make_train_step(_port(HD576), topt)(
        ts, torch.tensor(toks, dtype=torch.long), torch.tensor(mask))
    adam = js.opt_state[1][0]
    assert abs(float(tm["loss"]) - float(jm["loss"])) < 2e-6
    np.testing.assert_allclose(float(tm["grad_norm"]),
                               float(jm["grad_norm"]), rtol=1e-6)
    for what, want, got in (("params", js.params, ts.params),
                            ("mu", adam.mu, ts.opt_state.mu),
                            ("nu", adam.nu, ts.opt_state.nu)):
        jl = [np.asarray(a, np.float32) for a in jax.tree.leaves(want)]
        tl = [t.detach().float().numpy() for _, t in tstep._leaves(got)]
        assert len(jl) == len(tl)
        # nu is ~g^2: its scale sets the absolute tolerance; Adam's update
        # of a gradient within rounding noise of zero is ill-conditioned,
        # so one element in a thousand may miss atol + rtol, all within
        # `loose`
        atol = 5e-6 * (1e-3 if what == "nu" else 1)
        loose = 3e-5 if what == "params" else atol
        for a, b in zip(jl, tl):
            bad = np.abs(b - a) > atol + 1e-5 * np.abs(a)
            assert bad.mean() <= 1e-3, f"{what}: {int(bad.sum())} outside"
            np.testing.assert_allclose(b, a, atol=loose, rtol=1e-5,
                                       err_msg=what)


HOPPER = SOURCE.with_name("hopper.cuh")


@pytest.mark.parametrize("d", (*ROUTED_DIMS, 2112, 4096))
def test_f32_backward_clusters_up_to_2048_then_groups(d):
    """The f32 K1, K2 and K3 above 512 run a row tile on a cluster of
    ceil(d / 256) blocks, one a column group, while that is at most
    WIDE_CLUSTER_MAX (the source's CLUSTER_MAX, the portable 8: d 2048),
    and as independent column groups past it, a route by head dim that the
    source's f32_design states for all three kernels alike."""
    text = SOURCE.read_text()
    assert tfa.WIDE_CLUSTER_MAX == 8
    assert re.search(rf"constexpr int CLUSTER_MAX = "
                     rf"{tfa.WIDE_CLUSTER_MAX};", text)
    rule = re.search(r"constexpr int f32_design\(int kernel, int d\) \{"
                     r"(.*?)\}", text, re.S).group(1)
    assert "(d + DQ_W_F32 - 1) / DQ_W_F32 > CLUSTER_MAX" in rule
    assert "kernel" not in rule
    assert re.search(r"FWD_W_F32 == DQ_W_F32 && DQ_W_F32 == DKV_W_F32", text)
    groups = -(-d // tfa.WIDE_COLUMNS["flash_bwd_dq"])
    for name in KERNELS:
        got = tfa.wide_f32_cluster(d, name)
        assert (got > 1) == (d <= 2048)
        if d <= 2048:
            assert got == groups == len(tfa.wide_groups(d, name))
            assert 3 <= got <= 8
    assert tfa.wide_f32_cluster(832, "flash_bwd_dq") == 4
    assert tfa.wide_f32_cluster(832, "flash_fwd") == 4
    assert tfa.wide_groups(832, "flash_bwd_dq")[-1] == (768, 64)


@pytest.mark.parametrize("d", (*ROUTED_DIMS, 2112, 4096))
def test_bf16_k3_clusters_up_to_2048_then_groups(d):
    """The bf16 K3 above 512 (``wide_cluster``, the mirror of the source's
    wide_design) runs a key tile on a cluster of ceil(d / 256) blocks up to
    WIDE_CLUSTER_MAX of them where the last holds at least 192 columns, and
    as column groups past it and where the last holds 64 or 128 (d 576,
    640, 832); the bf16 K1 and K2 are column groups at every d; a
    -DFLASH_OTHER_DESIGNS=1 build runs the column groups everywhere. The
    launch is the cluster's, with the groups' key tiles."""
    text = SOURCE.read_text()
    rule = re.search(r"constexpr int wide_design\(int kernel, int d\) \{"
                     r"(.*?)\}", text, re.S).group(1)
    assert " ".join(rule.split()) == (
        "return kernel == 2 && !FLASH_OTHER_DESIGNS && (d + DKV_W - 1) / "
        "DKV_W <= CLUSTER_MAX && (d % DKV_W == 0 || d % DKV_W >= 3 * DKV_W "
        "/ 4) ? kWideCluster : kWideGroups;")
    assert tfa.WIDE_CLUSTER_KERNELS == ("flash_bwd_dkv",)
    w = tfa.WIDE_COLUMNS["flash_bwd_dkv"]
    groups = -(-d // w)
    full = d % w == 0 or d % w >= 3 * w // 4
    for name in KERNELS:
        got = tfa.wide_cluster(d, name)
        clustered = (name == "flash_bwd_dkv" and full
                     and groups <= tfa.WIDE_CLUSTER_MAX)
        assert got == (groups if clustered else 1)
    assert [tfa.wide_cluster(x, "flash_bwd_dkv")
            for x in (576, 640, 704, 768, 832, 1024, 2048, 2112)] == [
        1, 1, 3, 3, 1, 4, 8, 1]
    assert "return launch_cluster(dkv_wide<DKV_W>, blocks, a.groups," in text
    assert "return launch(dkv_wide_groups<DKV_W>, blocks," in text
    assert "static_assert(DkvWide<DKV_W>::BK == L::BK" in text



@pytest.mark.parametrize("d", (*ROUTED_DIMS, 1280, 1536, 1728, 2112))
def test_bf16_k1_k2_stream_column_groups_at_every_d(d):
    """The bf16 K1 and K2 above 512 run ceil(d / 256) independent column
    groups at every d (``wide_cluster`` 1, a plain launch; a row tile's
    groups on one cluster, each chunk multicast to them, lost to this in
    turns at every d it was timed at), each group forming the scores over
    the whole head dim. Inside the chunk loop the ring's refill of the
    previous step's stage is issued while this step's wgmmas run,
    predicated inside the copies and split between the two warpgroups'
    first threads, with no branch; it needs a tile's second step, so the
    bf16 route starts at two chunks (d 128)."""
    text = SOURCE.read_text()
    for name in ("flash_fwd", "flash_bwd_dq"):
        assert tfa.wide_cluster(d, name) == 1
        assert len(tfa.wide_groups(d, name)) == -(-d // 256)
    for kernel, const in (("flash_fwd_wide", "FWD_W"), ("dq_wide", "DQ_W")):
        assert (f"  return launch({kernel}<{const}>, a.nq * a.groups * h * "
                "batch, THREADS,") in text
        assert f"launch_cluster({kernel}<" not in text
        start = text.index(f"{kernel}(const __grid_constant__ ")
        body = text[start:text.index("\n}\n", start)]
        loop = body[body.index("for (int cc = 0; cc < nc; ++cc) {"):]
        loop = loop[:loop.index("bar_sync(1, THREADS);")]
        refill = ("load_step(issuer && j >= 1 && j - 1 + STAGES < steps, "
                  "j - 1 + STAGES);")
        assert loop.index("wgmma_commit();") < loop.index(refill) < (
            loop.index("wgmma_wait<0>();"))
        assert "if (" not in loop
        assert "const bool p0 = p && part == 0, p1 = p && part == 1;" in body
    assert "d >= 128 && d % 64 == 0 && (bf16_in || d >= F32_MIN_D)" in text


@pytest.mark.parametrize("kernel", ["FwdWide", "DqWide"])
def test_streamed_k1_k2_rings_fit(kernel):
    """K1's and K2's shared memory: the ring's steps, the output product's
    tile, a `full` mbarrier a step and one for the tile, within SMEM_MAX.
    K1 holds one V tile of 128 keys x 256 columns and 5 steps of a 128-row
    Q chunk and a 128-key K chunk; K2 one tile of K's 256 columns of 32
    keys and 5 steps of Q, dO, K and V chunks (each tile loaded at its
    tile's second step); one step more fits in neither."""
    text = SOURCE.read_text()
    struct = text[text.index(f"struct {kernel} {{"):]
    struct = struct[:struct.index("\n};\n")]
    consts = {k: int(v) for k, v in re.findall(r"constexpr int (\w+) = "
                                               r"(\d+);", text)}
    smem_max, row = consts["SMEM_MAX"], consts["ROW"]
    assert "BQ = 128;" in struct
    if kernel == "FwdWide":
        assert "V_STAGES = 1;" in struct and "FIT < 8 ? FIT : 8;" in struct
        assert "BK = 128;" in struct
        step, fixed, cap, tiles = 2 * 128 * row, 4 * 128 * row, 8, 1
    else:
        assert "KG_STAGES = 1;" in struct and "FIT < 6 ? FIT : 6;" in struct
        assert "BK = 32;" in struct
        step, fixed, cap, tiles = 2 * 128 * row + 2 * 32 * row, 4 * 32 * row, 6, 1
    assert "8 * (STAGES + " in struct and "STAGES) + 1024;" in struct
    stages = min((smem_max - 2048 - tiles * fixed) // step, cap)
    assert stages == 5
    assert stages * step + tiles * fixed + 8 * (stages + tiles) + 1024 <= (
        smem_max)
    assert (stages + 1) * step + tiles * fixed > smem_max - 2048

def _cluster_sum(units):
    """hopper.cuh's ClusterSum sizing for UNITS 16-byte units a thread:
    its TOTAL units a block, a rank's largest share at n, the `rs` slots a
    rank needs at n and the most any n up to 8 needs (RS_UNITS), mirrored
    from the source's expressions (checked to be there)."""
    text = HOPPER.read_text()
    helper = text[text.index("struct ClusterSum {"):]
    helper = helper[:helper.index("\n};\n")]
    for expr in ("return (TOTAL + n - 1) / n;", "return (n - 1) * share(n);",
                 "return r * TOTAL / n;", "return ((u + 1) * n - 1) / TOTAL;",
                 "static constexpr int BYTES = (RS_UNITS + TOTAL) * 16;",
                 "const int slot = row * share(n) + u - first(o, n);",
                 "rs[(src < rank ? src : src - 1) * share(n) + u - lo]",
                 "static constexpr int RS_UNITS = most(NMAX);"):
        assert expr in helper, expr
    total = 256 * units
    share = lambda n: -(-total // n)  # noqa: E731
    rs = lambda n: (n - 1) * share(n)  # noqa: E731
    return total, share, rs, max(rs(n) for n in range(2, 9))


@pytest.mark.parametrize("units", [2, 4])
@pytest.mark.parametrize("n", range(1, 9))
def test_cluster_sum_owns_each_unit_once(units, n):
    """ClusterSum's index arithmetic for the f32 K1's and K3's 2 and the f32
    K2's and bf16 K3's 4 units a thread
    at every cluster size: each unit has one owner, whose range holds it;
    every rank owns some; the partials sent to an owner land in distinct
    `rs` slots inside the buffer and its `rs` barrier expects exactly their
    bytes, its `ag` barrier the sums it does not own; the thread that
    re-arms `rs` owns a unit (so it waits on `rs` too); the receive
    buffers are at most 2 (n - 1) / n of a tile's partials, slots rounded
    up."""
    total, share, rs, rs_units = _cluster_sum(units)
    first = [r * total // n for r in range(n + 1)]
    owner = [((u + 1) * n - 1) // total for u in range(total)]
    for u, o in enumerate(owner):
        assert first[o] <= u < first[o + 1]
    for r in range(n):
        cnt = first[r + 1] - first[r]
        assert 0 < cnt <= share(n)
        slots = {(src if src < r else src - 1) * share(n) + u - first[r]
                 for src in range(n) if src != r
                 for u in range(first[r], first[r + 1])}
        assert len(slots) == (n - 1) * cnt  # the rs barrier's bytes / 16
        assert all(0 <= s < rs_units for s in slots)
        t = first[r] % 256
        assert owner[(first[r] // 256) * 256 + t] == r
        received = (n - 1) * cnt + (total - cnt)
        assert received <= 2 * (n - 1) / n * total + n
    assert rs(n) <= rs_units


@pytest.mark.parametrize("n", [3, 4, 8])
@pytest.mark.parametrize("kernel", ["DqWideF32", "DkvWideF32", "FwdWideF32",
                                    "DkvWide"])
def test_cluster_tiles_fit_with_their_exchange(kernel, n):
    """dq_wide_f32's and dkv_wide_f32's shared memory at clusters of 3 (d
    768), 4 (d 1024) and 8 (d 2048): the ring's stages, two tiles' (K2) or
    items' (K3) W columns of the output product's row operand and of its
    score operand, and ClusterSum's buffers and barriers (sized for any n
    up to 8) within SMEM_MAX; one stage more does not fit (K2 keeps the
    ring's 4); and a buffer for every peer's whole partials in place of
    the reduce-scatter's would not fit beside them at n 8. flash_fwd_wide_f32
    (K1) and dkv_wide (bf16 K3): ``_fwd_and_bf16_k3_budgets``."""
    text = SOURCE.read_text()
    struct = text[text.index(f"struct {kernel} {{"):]
    struct = struct[:struct.index("\n};\n")]
    consts = {k: int(v) for k, v in re.findall(r"constexpr int (\w+) = "
                                               r"(\d+);", text)}
    if kernel in ("FwdWideF32", "DkvWide"):
        _fwd_and_bf16_k3_budgets(kernel, n, struct, consts)
        return
    smem_max, c = consts["SMEM_MAX"], consts["F32_C"]
    cp, max_st, w = c + 4, consts["F32_MAX_ST"], consts["DQ_W_F32"]
    dq = kernel == "DqWideF32"
    rows, keys = ((64, 32) if dq else (32, 32))
    assert f"BQ = {rows if dq else keys}, BK = {keys}" in struct or (
        f"BK = {keys}, BQ = {rows}" in struct)
    units = 2 * (rows // 16) * (keys // 16) // 4 if dq else (
        (keys // 16) * (rows // 8) // 4)
    assert units == (4 if dq else 2)
    total, share, rs, rs_units = _cluster_sum(units)
    assert rs(n) <= rs_units
    step = 2 * (rows + keys) * cp * 4
    # K2: K's columns [2][BK][W + 4], dS^T [2][BK][BQ + 4]; K3: Q's and
    # dO's columns [2][2][BQ][W + 4], P^T and dS^T [2][2][BQ][BK + 4]
    fixed = (4 * 2 * keys * ((w + 4) + (rows + 4)) if dq
             else 4 * 4 * rows * ((w + 4) + (keys + 4)))
    exchange = (rs_units + total) * 16 + 16
    st = min((smem_max - fixed - exchange) // step, max_st)
    assert st == (4 if dq else 3)
    assert st * step + fixed + exchange <= smem_max
    assert (st + 1) * step + fixed + exchange > smem_max or st == max_st
    if n == 8:
        assert (st * step + fixed + (7 * total + total) * 16 + 16
                > smem_max)


def _fwd_and_bf16_k3_budgets(kernel, n, struct, consts):
    """The f32 K1's and the bf16 K3's shared memory on a cluster of n.
    flash_fwd_wide_f32: 32-key tiles (4 x 2 scores a thread, 2 units), a
    step of Q's 64 rows and 32 keys of K and V (36-float pitch), two tiles'
    256 columns of V, two P^T and ClusterSum<2> fit with the ring's 4
    stages; at 64-key tiles two V tiles, two P^T and ClusterSum<4> leave
    room for one stage. dkv_wide: K and V's 256 columns of 64 keys resident
    (64 KB), 32-query stages of Q's and dO's 256 columns (32 KB), a 4 KB
    P^T buffer and two ClusterSum<4>s (both warpgroups' 16 partial scores
    a thread; two stages' exchanges in flight) fit three stages and not
    four; 64-query stages (two ClusterSum<8>s) fit none."""
    smem_max = consts["SMEM_MAX"]
    if kernel == "FwdWideF32":
        assert "BQ = 64, BK = 32" in struct
        assert "using X = ClusterSum<SR * SC / 4, CLUSTER_MAX>;" in struct
        cp, max_st, w = consts["F32_C"] + 4, consts["F32_MAX_ST"], 256

        def budget(keys):
            units = (64 // 16) * (keys // 16) // 4
            total, share, rs, rs_units = _cluster_sum(units)
            assert rs(n) <= rs_units
            step = (64 + 2 * keys) * cp * 4
            fixed = 4 * 2 * keys * ((w + 4) + (64 + 4))
            exchange = (rs_units + total) * 16 + 16
            return units, step, fixed + exchange

        units, step, fixed = budget(32)
        assert units == 2
        st = min((smem_max - fixed) // step, max_st)
        assert st == max_st == 4 and st * step + fixed <= smem_max
        units, step, fixed = budget(64)
        assert units == 4 and (smem_max - fixed) // step == 1
        return
    assert "BK = 64;" in struct and "BQ = 32;" in struct
    assert "using X = ClusterSum<BQ / 8, CLUSTER_MAX>;" in struct
    assert "2 * KV_BYTES + 2 * X::BYTES + XCH * 4 +" in struct

    def budget(rows):
        units = rows // 8  # BQ / 2 scores a thread
        total, share, rs, rs_units = _cluster_sum(units)
        assert rs(n) <= rs_units
        step = 2 * rows * 256 * 2
        fixed = (2 * 64 * 256 * 2 + 2 * (rs_units + total) * 16
                 + rows // 4 * 128 * 4 + 8 * (1 + 6 + 2 * 2) + 1024)
        return units, step, fixed

    units, step, fixed = budget(32)
    assert units == 4
    assert (smem_max - fixed) // step == 3
    assert 3 * step + fixed <= smem_max < 4 * step + fixed
    units, step, fixed = budget(64)
    assert units == 8 and (smem_max - fixed) // step == 0
