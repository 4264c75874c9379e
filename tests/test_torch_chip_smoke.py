"""The tables of chip_smoke.py and kernel_variants.py, read on the CPU.

chip_smoke.py's profile groups its device time by kernel name, and its
``kernels`` line names the TPU kernel each port kernel replaces, by line
in the JAX package's ops/flash_attention.py: both go stale silently when
a kernel is renamed or that file moves, so they are checked here against
the sources (the JAX file is read as text, not imported).
kernel_variants.py rebuilds K1, K2 and K3 with text edits of their
committed sources and the headers beside them, which must each still
match exactly once.
"""

import importlib.util
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
CSRC = ROOT / "service_account_auth_improvements_tpu_torch" / "csrc"
JAX_FLASH = (ROOT / "service_account_auth_improvements_tpu" / "ops"
             / "flash_attention.py")


def _script(name):
    spec = importlib.util.spec_from_file_location(name, ROOT / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


chip_smoke = _script("chip_smoke")
kernel_variants = _script("kernel_variants")


def _global_kernels():
    pattern = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)"
                         r"\s+)?(\w+)\s*\(")
    return {m.group(1) for cu in CSRC.glob("*.cu")
            for m in pattern.finditer(cu.read_text())}


@pytest.mark.parametrize("kernel", sorted(chip_smoke.PROFILE_KERNELS))
def test_profile_groups_name_a_global_kernel(kernel):
    assert kernel in _global_kernels()


@pytest.mark.parametrize("name", sorted(chip_smoke.KERNELS))
def test_replaces_points_at_the_tpu_kernel(name):
    source, fn, line = chip_smoke.KERNELS[name]
    assert (CSRC / source).is_file()
    assert re.fullmatch(r"_\w+_kernel|_flash_\w+", fn)
    text = JAX_FLASH.read_text().splitlines()[line - 1]
    assert text.startswith(f"def {fn}("), text


@pytest.mark.parametrize("variant", sorted(kernel_variants.VARIANTS))
def test_kernel_variant_edits_match_the_source(variant):
    key, *shown = kernel_variants.VARIANTS[variant][2:]
    assert key in kernel_variants.KERNEL_HEADS
    kernel = kernel_variants.template_of(key)
    assert {kernel, *shown} <= _global_kernels()
    _, _, d = kernel_variants.KERNEL_HEADS[key]
    assert key in (kernel, f"{kernel}<{d}>")
    source = kernel_variants.source_of(kernel)
    files = kernel_variants.committed_files(source)
    assert set(files) == {f"{source}.cu"} | {h.name
                                            for h in CSRC.glob("*.cuh")}
    assert re.search(rf"void\s+(?:__launch_bounds__\([^)]*\)\s+)?{kernel}\(",
                     files[f"{source}.cu"])
    out = kernel_variants.variant_files(variant, files)
    for old, new in kernel_variants.VARIANTS[variant][1]:
        assert any(new in text for text in out.values())
    with pytest.raises(ValueError, match="exactly once"):
        kernel_variants.variant_files(
            variant, {f: text + text for f, text in files.items()})


def test_lifecycle_settings():
    """The lifecycle phase's draft shares the target's vocabulary, resumes
    mid-run, and keeps its checkpoints under the gitignored build/."""
    from service_account_auth_improvements_tpu_torch.models import llama

    target = llama.PRESETS[chip_smoke.PRESET]
    draft = llama.PRESETS[chip_smoke.DRAFT]
    assert draft.vocab_size == target.vocab_size
    assert draft.attn_impl == target.attn_impl == "flash"
    assert 0 < chip_smoke.RESUME_AT < chip_smoke.LIFECYCLE_STEPS
    assert chip_smoke.LIFECYCLE_STEPS % chip_smoke.RESUME_AT == 0
    ignored = (ROOT / ".gitignore").read_text().splitlines()
    assert "/build/" in ignored
    for workdir in (chip_smoke.WORKDIR, chip_smoke.CLI_WORKDIR):
        assert workdir.parent == ROOT / "build"


def test_moe_settings():
    """The MoE phase drives a flash MoE preset (K1/K2/K3 on every layer)
    whose routing-group count at the training shape differs from its
    expert count and from the tokens routed: the profile tells expert
    products, dispatch and combine, and the one-hot products apart by the
    batch of their bmm."""
    from service_account_auth_improvements_tpu_torch.models import llama

    cfg = llama.PRESETS[chip_smoke.MOE_PRESET]
    assert cfg.moe_experts and cfg.moe_top_k == 1
    assert cfg.attn_impl == "flash" and cfg.head_dim == 128
    # the kernel checks' MoE cases are at this preset's heads
    assert (cfg.n_heads, cfg.n_kv_heads) == (chip_smoke.MOE_HEADS,
                                             chip_smoke.MOE_KV_HEADS)
    g = min(cfg.moe_group_size, chip_smoke.TRAIN_SEQ)
    groups = chip_smoke.TRAIN_BATCH * chip_smoke.TRAIN_SEQ // g
    assert len({cfg.moe_experts, groups, groups * g}) == 3
    assert chip_smoke.MOE_TOP2_STEPS >= 2 and chip_smoke.TRAIN_STEPS >= 2
    assert 0.99 <= chip_smoke.MOE_ROUTING_AGREE < 1


@pytest.mark.parametrize("hf,preset", [("HF_LLAMA31_8B", "llama3_8b"),
                                       ("HF_LLAMA32_1B", "llama3_1b")])
def test_finetune_configs_are_the_presets(hf, preset):
    """Phase 8's HF configs convert to the port's Llama-3.1-8B and
    Llama-3.2-1B presets in every field but the context length; the
    kernel checks run at their heads and head dims; LoRA resumes mid-run
    and the work directories are under the gitignored build/."""
    import dataclasses

    from service_account_auth_improvements_tpu_torch.models import (
        convert_hf,
        llama,
    )

    cfg = convert_hf.config_from_hf(getattr(chip_smoke, hf))
    want = llama.PRESETS[preset]
    diff = {k for k, v in dataclasses.asdict(cfg).items()
            if v != getattr(want, k)}
    assert diff == {"max_seq_len"}
    assert (cfg.n_heads, cfg.n_kv_heads) == (32, 8)
    assert cfg.head_dim in dict(chip_smoke.FT_HEAD_DIMS).values()
    assert getattr(chip_smoke, hf)["tie_word_embeddings"] == (
        preset == "llama3_1b")
    assert 0 < chip_smoke.RESUME_AT < chip_smoke.LORA_STEPS
    assert chip_smoke.DISTILL_STEPS >= 2
    assert chip_smoke.FT_WORKDIR.parent == ROOT / "build"


def test_side_model_settings():
    """Phase 9's ResNet-50 count is the canonical one and the port's
    tree's; every timed loop has a warm-up and a timed step."""
    from service_account_auth_improvements_tpu_torch.models import resnet

    assert chip_smoke.RESNET50_PARAMS == 25_557_032 == resnet.PRESETS[
        "resnet50"].param_count()
    assert chip_smoke.RESNET_STEPS >= 2 and chip_smoke.MNIST_STEPS >= 2
    assert chip_smoke.RESNET_SIZE == 224


def test_parallel_settings():
    """Phase 10 times steps after a warm-up, splits the training sequence
    evenly into the ring's chunks, and holds ring-vs-dense gradients in
    f32 to a limit tighter than bf16's, with a control ring that sees
    at least one future key."""
    assert 2 <= chip_smoke.PARALLEL_STEPS <= 3
    assert chip_smoke.TRAIN_SEQ % chip_smoke.RING_CHUNKS == 0
    assert chip_smoke.RING_CHUNKS > 1
    assert chip_smoke.RING_CONTROL_PEEK >= 1
    assert (chip_smoke.GRAD_TOL["f32"]["leaf"]
            < chip_smoke.GRAD_TOL["bf16"]["leaf"])


def test_wide_head_settings():
    """Phase 12's configurations keep the preset's h * d (so wq and wo
    keep their shapes and each kernel does the preset's work), take head
    dims the kernels take (the per-dim ones up to 512, the streamed ones
    above, in bf16 and f32 alike), differ from the preset only in their
    heads, and time steps after a warm-up."""
    import dataclasses

    import torch

    from service_account_auth_improvements_tpu_torch.models import llama
    from service_account_auth_improvements_tpu_torch.ops import (
        flash_attention as fa,
    )

    base = llama.PRESETS[chip_smoke.PRESET]
    assert sorted(d for _, _, d in chip_smoke.WIDE_HEADS.values()) == [
        192, 256, 384, 512, 768]
    for name, (h, hkv, d) in chip_smoke.WIDE_HEADS.items():
        assert name == f"{chip_smoke.PRESET}_d{d}"
        assert h % hkv == 0
        # the per-dim kernels up to 512, the streamed ones above, in both
        # dtypes
        assert (d in fa.KERNEL_HEAD_DIMS) == (d <= chip_smoke.PER_DIM_MAX)
        for dtype in (torch.bfloat16, torch.float32):
            assert fa.kernel_route("flash_fwd", d, dtype)[0] == (
                "flash_fwd" if d <= chip_smoke.PER_DIM_MAX
                else chip_smoke.WIDE_SOURCE)
        assert h * d == base.n_heads * base.head_dim
        cfg = dataclasses.replace(base, n_heads=h, n_kv_heads=hkv,
                                  head_dim=d)
        assert cfg.q_dim == base.q_dim and cfg.attn_impl == "flash"
    d256 = dataclasses.replace(base, n_heads=6, n_kv_heads=2, head_dim=256)
    assert d256.param_count() == base.param_count()
    # d 512 keeps wk/wv at the preset's 1536 x 512 too, so its parameter
    # count; d 384 has d 192's 1536 x 768
    d512 = dataclasses.replace(base, n_heads=3, n_kv_heads=1, head_dim=512)
    assert d512.param_count() == base.param_count()
    d384 = dataclasses.replace(base, n_heads=4, n_kv_heads=2, head_dim=384)
    d192 = dataclasses.replace(base, n_heads=8, n_kv_heads=4, head_dim=192)
    assert d384.param_count() == d192.param_count()
    # d 768 keeps wq at 1536 x 1536, and wk/wv at d 192's 1536 x 768
    d768 = dataclasses.replace(base, n_heads=2, n_kv_heads=1, head_dim=768)
    assert d768.param_count() == d192.param_count()
    assert chip_smoke.WIDE_HEADS["bench_800m_d512"] == (3, 1, 512)
    assert chip_smoke.WIDE_HEADS["bench_800m_d384"] == (4, 2, 384)
    assert chip_smoke.WIDE_HEADS["bench_800m_d768"] == (2, 1, 768)
    assert set(chip_smoke.WIDE_SERVED) == {256, 512, 768}
    assert set(chip_smoke.WIDE_VS_DENSE) == {384, 512, 768}
    assert chip_smoke.WIDE_STEPS >= 2
    assert chip_smoke.PER_DIM_MAX == fa.KERNEL_HEAD_DIMS[-1] == 512



@pytest.mark.parametrize("d", sorted(chip_smoke.CLUSTER_SIZE_HEADS))
def test_cluster_size_dims_run_at_small_shapes(d):
    """Phase 3 runs the streamed kernels at d 1280, 1536 and 1728, where
    the bf16 K3 runs on clusters of 5, 6 and 7 blocks (the last block full,
    full, 192 columns) and the f32 kernels at d 1280 and 1728 too, through
    autograd against the plain versions at CLUSTER_SIZE_EDGES: small shapes
    (b 2, s up to 300, one row, one past a 128-row block, non-causal), so
    the run stays short."""
    from service_account_auth_improvements_tpu_torch.ops import (
        flash_attention as fa,
    )

    h, hkv = chip_smoke.CLUSTER_SIZE_HEADS[d]
    assert h % hkv == 0 and d > chip_smoke.PER_DIM_MAX and d % 64 == 0
    n = {1280: 5, 1536: 6, 1728: 7}[d]
    assert fa.wide_cluster(d, "flash_bwd_dkv") == n
    assert fa.wide_f32_cluster(d, "flash_bwd_dq") == n
    assert fa.wide_cluster(d, "flash_fwd") == 1
    assert set(chip_smoke.CLUSTER_SIZE_F32) == {1280, 1728}
    assert all(b == 2 and s <= 300
               for b, s, _ in chip_smoke.CLUSTER_SIZE_EDGES)
    assert {s for _, s, _ in chip_smoke.CLUSTER_SIZE_EDGES} >= {1, 129}
    assert not all(c for _, _, c in chip_smoke.CLUSTER_SIZE_EDGES)
    src = (ROOT / "chip_smoke.py").read_text()
    assert "for d, (h, hkv) in CLUSTER_SIZE_HEADS.items()]" in src
    assert "CLUSTER_SIZE_EDGES)" in src

def test_kernel_only_head_settings():
    """Phase 3 checks and times K1, K2 and K3 at every head dim the split
    kernels take (d 320 and 448 with no model, 4 / 2 heads), at the
    streamed kernels' kernel-only dims (576 and 640 at 4 / 2 heads, 704
    and 1024 at 2 / 1, 2048 at 1 / 1), and at d 256 under both designs;
    the d 512 kernels line carries the split kernels' kernel-only dims and
    the d 768 line the streamed ones'; the profile groups name the split
    and the streamed kernels, and the d 192 and 256 design labels come
    from K1's, K2's and K3's design functions."""
    from service_account_auth_improvements_tpu_torch.ops import (
        flash_attention as fa,
    )

    assert chip_smoke.KERNEL_ONLY_HEADS == {
        "d320": (4, 2, 320), "d448": (4, 2, 448), "d576": (4, 2, 576),
        "d640": (4, 2, 640), "d704": (2, 1, 704), "d1024": (2, 1, 1024),
        "d2048": (1, 1, 2048)}
    for label, (h, hkv, d) in chip_smoke.KERNEL_ONLY_HEADS.items():
        assert label == f"d{d}" and h % hkv == 0
    dims = sorted(d for _, _, d in chip_smoke._kernel_heads().values())
    assert dims == [192, 256, 320, 384, 448, 512, 576, 640, 704, 768,
                    1024, 2048]
    assert {d for d in dims if d <= 512} <= set(fa.KERNEL_HEAD_DIMS)
    assert all(d % 64 == 0 for d in dims)
    assert fa.KERNEL_HEAD_DIMS[-1] == 512
    for kernel in ("flash_fwd_split", "dq_split", "dkv_split",
                   *chip_smoke.WIDE_KERNELS.values()):
        assert kernel in chip_smoke.PROFILE_KERNELS
    src = {name: (CSRC / f"{name}.cu").read_text()
           for name in chip_smoke.KERNEL_SOURCES}
    for name, fn in (("flash_fwd", "flash_fwd_design(int d)"),
                     ("flash_bwd", "flash_bwd_dq_design(int d)"),
                     ("flash_bwd", "flash_bwd_dkv_design(int d)")):
        assert f'extern "C" int {fn}' in src[name]
    for text in src.values():
        assert "#ifndef FLASH_OTHER_DESIGNS" in text
    assert chip_smoke.DESIGN_DIMS == (64, 192, 256, 320, 384, 448, 512)
    assert "dkv_pair" in chip_smoke.PROFILE_KERNELS


def _designs(source, enum):
    """csrc/<source>.cu's design enum, read as text: {name: id}."""
    text = (CSRC / f"{source}.cu").read_text()
    body = re.search(rf"enum {enum} \{{([^}}]*)\}}", text).group(1)
    return {m.group(1): int(m.group(2))
            for m in re.finditer(r"(\w+) = (\d+)", body)}


def _bwd_designs():
    return _designs("flash_bwd", "BwdDesign")


class _Fwd:
    """A flash_fwd library's design function, as csrc/flash_fwd.cu states
    it: the twin blocks at d 64, the rows on 8 warps at d 256, the pair of
    blocks at d 384 and 512, the row split at d 128 and 192 (the other
    build: the row split at d 64 and 256, the rows on 8 warps at d 192, the
    D split at d 384 and 512), the D split at d 320 and 448, the streamed
    kernel of csrc/flash_wide.cu above 512 (in both builds)."""

    def __init__(self, other):
        ids = _designs("flash_fwd", "FwdDesign")
        two = {64: ("kTwin", "kRowSplit"), 192: ("kRowSplit", "kRows8"),
               256: ("kRows8", "kRowSplit"), 384: ("kPair", "kDSplit"),
               512: ("kPair", "kDSplit")}
        self.flash_fwd_design = lambda d: ids[
            "kRowSplit" if d == 128 else two[d][1 if other else 0]
            if d in two else "kWide" if d > 512 else "kDSplit"]


def test_fwd_design_labels_name_every_design():
    """chip_smoke.py labels each id K1's design function can return, and
    no other, with the names K2's and K3's ids of the same design carry
    (the twin blocks and the pair of blocks of 128 rows, K1's alone, take
    ids no K2 or K3 design has); the source's rule: the twin blocks at d
    64, the rows on 8 warps at d 256, the pair of blocks at d 384 and 512,
    the row split at d 128 and 192 (a -DFLASH_OTHER_DESIGNS=1 build takes
    the row split at d 64 and 256, the rows on 8 warps at d 192 and the D
    split at d 384 and 512), the D split at d 320 and 448, and above 512
    the head dim streamed (csrc/flash_wide.cu, in both builds), an id K2
    and K3 share, with the same label."""
    ids = _designs("flash_fwd", "FwdDesign")
    assert ids == {"kRowSplit": 0, "kDSplit": 1, "kRows8": 2, "kTwin": 5,
                   "kPair": 7, "kWide": 8}
    assert set(chip_smoke.FWD_DESIGNS) == set(ids.values())
    assert ids["kTwin"] not in chip_smoke.BWD_DESIGNS
    assert ids["kPair"] not in chip_smoke.BWD_DESIGNS
    assert ids["kWide"] == _bwd_designs()["kWide"]
    for n, label in chip_smoke.FWD_DESIGNS.items():
        assert chip_smoke.BWD_DESIGNS.get(n, label) == label
    assert len(set(chip_smoke.FWD_DESIGNS.values())) == len(ids)
    text = (CSRC / "flash_fwd.cu").read_text()
    rule = re.search(r"constexpr int fwd_design\(int d\) \{(.*?)\}", text,
                     re.S).group(1)
    assert " ".join(rule.split()) == (
        "return d == 64 ? (FLASH_OTHER_DESIGNS ? kRowSplit : kTwin) : d <= "
        "128 ? kRowSplit : d == 192 ? (FLASH_OTHER_DESIGNS ? kRows8 : "
        "kRowSplit) : d == 256 ? (FLASH_OTHER_DESIGNS ? kRowSplit : kRows8) "
        ": d == 384 || d == 512 ? (FLASH_OTHER_DESIGNS ? kDSplit : kPair) : "
        "d > 512 ? kWide : kDSplit;")
    assert 'extern "C" int flash_fwd_design(int d) { return fwd_design(d); }' \
        in text
    for d, shipped, other in ((64, "twin blocks of 8 warps", "row split"),
                              (128, "row split", "row split"),
                              (192, "row split", "rows on 8 warps"),
                              (256, "rows on 8 warps", "row split"),
                              (320, "D split", "D split"),
                              (384, "rows on a cluster of two", "D split"),
                              (448, "D split", "D split"),
                              (512, "rows on a cluster of two", "D split"),
                              (576, "head dim streamed, 256 columns a block",
                               "head dim streamed, 256 columns a block"),
                              (2048, "head dim streamed, 256 columns a "
                                     "block",
                               "head dim streamed, 256 columns a block")):
        assert chip_smoke.FWD_DESIGNS[_Fwd(False).flash_fwd_design(d)] == (
            shipped)
        assert chip_smoke.FWD_DESIGNS[_Fwd(True).flash_fwd_design(d)] == (
            other)


class _Bwd:
    """A flash_bwd library's design functions, as csrc/flash_bwd.cu states
    them: K2's dq_rows8 at d 64, 192 and 256 and its pair of blocks at d
    512 (dq_pair), K3's 8-warp designs at d 64 (dkv_keys8) and 256
    (dkv_onepass) and its pair of blocks at d 320 to 512 (dkv_pair), the
    row split at d 128 (and K3's at d 192), K2's D split above (the row
    split at d 64, 192 and 256, K3's one pass at d 192, the D split for
    the shipped pairs and K2's pair at d 384 in the other build), and the
    streamed kernels of csrc/flash_wide.cu above 512 (in both builds)."""

    def __init__(self, other):
        ids = _bwd_designs()
        row8, one, keys8 = ((ids["kRowSplit"],) * 3 if other
                            else (ids["kRows8"], ids["kOnePass"],
                                  ids["kKeys8"]))
        pair = ids["kDSplit" if other else "kPair"]
        self.flash_bwd_dq_design = lambda d: (
            row8 if d in (64, 192, 256) else ids["kRowSplit"] if d <= 128
            else pair if d == 512
            else ids["kPair" if other else "kDSplit"] if d == 384
            else ids["kWide"] if d > 512
            else ids["kDSplit"])
        self.flash_bwd_dkv_design = lambda d: (
            keys8 if d == 64 else ids["kRowSplit"] if d <= 128
            else one if d == 256
            else ids["kOnePass" if other else "kRowSplit"] if d == 192
            else pair if d in (320, 384, 448, 512)
            else ids["kWide"] if d > 512
            else ids["kDSplit"])


def test_bwd_design_labels_name_every_design():
    """chip_smoke.py labels each id K2's and K3's design functions can
    return, and no other; ``design_names`` reads K1's, K2's and K3's ids:
    at d 64 and 256 the 8-warp designs ship, at d 192 K2's, and a build
    with -DFLASH_OTHER_DESIGNS=1 runs the 12-warp row split there (and
    K1's rows on 8 warps and K3's one pass at d 192, where their row
    split ships); at d 384 and 512 K1 and K3 ship their pairs of blocks
    and K2 at d 512, and the other build runs the D split there; at d 384
    K2 ships the D split and the other build its pair; at d 320 and 448
    K3 ships its pair (the second block's last 64 columns TMA's zeros)
    and the other build the D split, which K1 and K2 run in both; above
    512 all three stream the head dim in both builds."""
    ids = _bwd_designs()
    assert ids == {"kRowSplit": 0, "kDSplit": 1, "kRows8": 2, "kOnePass": 3,
                   "kKeys8": 4, "kPair": 6, "kWide": 8}
    assert set(chip_smoke.BWD_DESIGNS) == set(ids.values())
    assert len(set(chip_smoke.BWD_DESIGNS.values())) == len(ids)

    shipped = chip_smoke.design_names(_Fwd(False), _Bwd(False), 256)
    other = chip_smoke.design_names(_Fwd(True), _Bwd(True), 256)
    assert shipped == {"flash_fwd": "rows on 8 warps",
                       "flash_bwd_dq": "rows on 8 warps",
                       "flash_bwd_dkv": "one pass"}
    assert other == {"flash_fwd": "row split", "flash_bwd_dq": "row split",
                     "flash_bwd_dkv": "row split"}
    # at d 192 all three have two designs
    assert chip_smoke.design_names(_Fwd(False), _Bwd(False), 192) == {
        "flash_fwd": "row split", "flash_bwd_dq": "rows on 8 warps",
        "flash_bwd_dkv": "row split"}
    assert chip_smoke.design_names(_Fwd(True), _Bwd(True), 192) == {
        "flash_fwd": "rows on 8 warps", "flash_bwd_dq": "row split",
        "flash_bwd_dkv": "one pass"}
    assert set(chip_smoke.design_names(_Fwd(False), _Bwd(False), 128)
               .values()) == {"row split"}
    # at d 64 all three have two designs
    assert chip_smoke.design_names(_Fwd(False), _Bwd(False), 64) == {
        "flash_fwd": "twin blocks of 8 warps",
        "flash_bwd_dq": "rows on 8 warps",
        "flash_bwd_dkv": "keys on 8 warps"}
    assert set(chip_smoke.design_names(_Fwd(True), _Bwd(True), 64)
               .values()) == {"row split"}
    pair = "a cluster of two, half the head dim a block"
    for d in (384, 512):
        assert chip_smoke.design_names(_Fwd(False), _Bwd(False), d) == {
            "flash_fwd": "rows on a cluster of two",
            "flash_bwd_dq": pair if d == 512 else "D split",
            "flash_bwd_dkv": pair}
        assert chip_smoke.design_names(_Fwd(True), _Bwd(True), d) == {
            "flash_fwd": "D split",
            "flash_bwd_dq": pair if d == 384 else "D split",
            "flash_bwd_dkv": "D split"}
    for d in (320, 448):
        assert chip_smoke.design_names(_Fwd(False), _Bwd(False), d) == {
            "flash_fwd": "D split", "flash_bwd_dq": "D split",
            "flash_bwd_dkv": pair}
        assert set(chip_smoke.design_names(_Fwd(True), _Bwd(True), d)
                   .values()) == {"D split"}
    for d in (576, 704, 768, 2048):
        for other in (False, True):
            assert set(chip_smoke.design_names(_Fwd(other), _Bwd(other), d)
                       .values()) == {"head dim streamed, 256 columns a "
                                      "block"}
    # the design functions follow the same rule in the source
    text = (CSRC / "flash_bwd.cu").read_text()
    rule = re.search(r"constexpr int dq_design\(int d\) \{(.*?)\}", text,
                     re.S).group(1)
    assert " ".join(rule.split()) == (
        "return d == 64 || d == 192 || d == 256 ? (FLASH_OTHER_DESIGNS ? "
        "kRowSplit : kRows8) : d <= 128 ? kRowSplit : d == 384 ? "
        "(FLASH_OTHER_DESIGNS ? kPair : kDSplit) : d == 512 ? "
        "(FLASH_OTHER_DESIGNS ? kDSplit : kPair) : d > 512 ? kWide : "
        "kDSplit;")
    rule = re.search(r"constexpr int dkv_design\(int d\) \{(.*?)\}", text,
                     re.S).group(1)
    assert " ".join(rule.split()) == (
        "return d == 64 ? (FLASH_OTHER_DESIGNS ? kRowSplit : kKeys8) : d <= "
        "128 ? kRowSplit : d == 192 ? (FLASH_OTHER_DESIGNS ? kOnePass : "
        "kRowSplit) : d == 256 ? (FLASH_OTHER_DESIGNS ? kRowSplit : "
        "kOnePass) : d >= 320 && d <= 512 ? (FLASH_OTHER_DESIGNS ? kDSplit "
        ": kPair) : d > 512 ? kWide : kDSplit;")


def test_design_kernels_name_the_shipped_and_other_kernels():
    """``design_kernels`` names the kernel template each design id runs
    (DESIGN_KERNELS, every one a kernel of csrc/): at d 64 K1, K2 and K3
    ship flash_fwd_twin, dq_rows8 and dkv_keys8, the other build runs
    flash_fwd_wgmma, dq_wgmma and dkv_wgmma there; at d 192 K2 ships
    dq_rows8, the other build runs dq_wgmma; at d 384 and 512 K1 and K3
    ship flash_fwd_pair and dkv_pair and the other build runs the split
    kernels there; K2 ships dq_pair at d 512 and dq_split at d 384, the
    other build the other one; at d 320 and 448 K3 ships dkv_pair and the
    other build dkv_split, K1 and K2 the split kernels in both."""
    fwd_ids = _designs("flash_fwd", "FwdDesign")
    bwd_ids = _bwd_designs()
    kernels = chip_smoke.DESIGN_KERNELS
    assert set(kernels["flash_fwd"]) == set(fwd_ids.values())
    assert set(kernels["flash_bwd_dq"]) | set(kernels["flash_bwd_dkv"]) == (
        set(bwd_ids.values()))
    for table in kernels.values():
        assert set(table.values()) <= _global_kernels()
    # the streamed kernels' id names csrc/flash_wide.cu's templates
    for name, kernel in chip_smoke.WIDE_KERNELS.items():
        assert kernels[name][fwd_ids["kWide"]] == kernel
    assert chip_smoke.design_kernels(_Fwd(False), _Bwd(False), 64) == {
        "flash_fwd": "flash_fwd_twin<64>", "flash_bwd_dq": "dq_rows8<64>",
        "flash_bwd_dkv": "dkv_keys8<64>"}
    assert chip_smoke.design_kernels(_Fwd(True), _Bwd(True), 64) == {
        "flash_fwd": "flash_fwd_wgmma<64>", "flash_bwd_dq": "dq_wgmma<64>",
        "flash_bwd_dkv": "dkv_wgmma<64>"}
    assert chip_smoke.design_kernels(_Fwd(False), _Bwd(False), 192) == {
        "flash_fwd": "flash_fwd_wgmma<192>", "flash_bwd_dq": "dq_rows8<192>",
        "flash_bwd_dkv": "dkv_wgmma<192>"}
    assert chip_smoke.design_kernels(_Fwd(True), _Bwd(True), 192) == {
        "flash_fwd": "flash_fwd_rows8<192>", "flash_bwd_dq": "dq_wgmma<192>",
        "flash_bwd_dkv": "dkv_onepass<192>"}
    assert chip_smoke.design_kernels(_Fwd(False), _Bwd(False), 256) == {
        "flash_fwd": "flash_fwd_rows8<256>",
        "flash_bwd_dq": "dq_rows8<256>",
        "flash_bwd_dkv": "dkv_onepass<256>"}
    for d in (384, 512):
        dq = ("dq_pair", "dq_split")[::1 if d == 512 else -1]
        assert chip_smoke.design_kernels(_Fwd(False), _Bwd(False), d) == {
            "flash_fwd": f"flash_fwd_pair<{d}>",
            "flash_bwd_dq": f"{dq[0]}<{d}>",
            "flash_bwd_dkv": f"dkv_pair<{d}>"}
        assert chip_smoke.design_kernels(_Fwd(True), _Bwd(True), d) == {
            "flash_fwd": f"flash_fwd_split<{d}>",
            "flash_bwd_dq": f"{dq[1]}<{d}>",
            "flash_bwd_dkv": f"dkv_split<{d}>"}
    for d in (320, 448):
        for other, dkv in ((False, "dkv_pair"), (True, "dkv_split")):
            assert chip_smoke.design_kernels(_Fwd(other), _Bwd(other), d) == {
                "flash_fwd": f"flash_fwd_split<{d}>",
                "flash_bwd_dq": f"dq_split<{d}>",
                "flash_bwd_dkv": f"{dkv}<{d}>"}


def test_d64_design_settings():
    """d 64's designs are timed in turns at Llama-3.2-1B's heads at the
    fine-tuning shape (phase 8's distillation student), and both builds are
    held at the d 64 blocks' edges: one row, ragged ends inside and one
    past a 128-row or 128-key block, s 2047, GQA group 4, non-causal."""
    hf = chip_smoke.HF_LLAMA32_1B
    assert hf["head_dim"] == 64
    assert chip_smoke.DESIGN_SHAPES[64] == (
        chip_smoke.FT_BATCH, chip_smoke.FT_SEQ, hf["num_attention_heads"],
        hf["num_key_value_heads"])
    assert set(chip_smoke.DESIGN_SHAPES) == set(chip_smoke.DESIGN_DIMS)
    for d in (192, 256, 384, 512):
        h, hkv, _ = chip_smoke.WIDE_HEADS[f"bench_800m_d{d}"]
        assert chip_smoke.DESIGN_SHAPES[d] == (
            chip_smoke.TRAIN_BATCH, chip_smoke.TRAIN_SEQ, h, hkv)
    edges = chip_smoke.D64_EDGES
    assert {s for _, s, _, _, _ in edges} >= {1, 65, 127, 191, 2047}
    assert any(h // hkv == 4 for _, _, h, hkv, _ in edges)
    assert any(not causal for *_, causal in edges)
    assert all(h % hkv == 0 for _, _, h, hkv, _ in edges)


def _d64_inputs():
    """Phase 3's numbers, phase 8's launches and phase_wide_designs'
    designs at d 64 as ``d64_kernel_entries`` reads them."""
    b, s, h, hkv = chip_smoke.DESIGN_SHAPES[64]
    shape = f"b{b} s{s} h{h} hkv{hkv} d64 bf16 causal"
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "library_backend", "tflops", "bound_share")
    numbers = {name: {"more_shapes": {shape: {key: 1.0 for key in keys}}}
               for name in chip_smoke.KERNELS}
    for name in ("flash_bwd_dq", "flash_bwd_dkv"):
        numbers[name]["more_shapes"][shape]["pair_ms"] = 2.0
    designs = {64: {"flash_fwd": {"shipped_kernel": "flash_fwd_twin<64>"},
                    "flash_bwd_dq": {"shipped_kernel": "dq_rows8<64>"},
                    "flash_bwd_dkv": {"shipped_kernel": "dkv_keys8<64>"}}}
    # the distillation step: K1 64 (the student's 32 at d 64, the
    # teacher's 32 at d 128), K2 and K3 16 each
    paths = {"distill_8b_1b": {"flash_fwd": 64, "flash_fwd d64": 32,
                               "flash_bwd_dq": 16, "flash_bwd_dkv": 16}}
    return shape, numbers, paths, designs


def test_d64_entries_carry_designs_and_pair():
    """K1's, K2's and K3's d 64 ``kernels`` entries: every key the line's
    contract names, the shipped kernel by name, launches summed over the
    paths that run them (the distillation student) and the designs timed
    in turns; K2's and K3's with the pair's sum; a path that launched
    none fails."""
    shape, numbers, paths, designs = _d64_inputs()
    entries = chip_smoke.d64_kernel_entries(numbers, paths, designs)
    contract = {"name", "route", "source", "replaces", "launches",
                "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms"}
    assert [e["name"] for e in entries] == ["flash_fwd d64",
                                            "flash_bwd_dq d64",
                                            "flash_bwd_dkv d64"]
    for entry, kernel in zip(entries, ("flash_fwd_twin<64>",
                                       "dq_rows8<64>", "dkv_keys8<64>")):
        assert contract <= set(entry)
        assert entry["kernel"] == kernel and entry["route"] == "cuda"
        assert entry["shape"] == shape
        assert ("pair_ms" in entry) == (kernel != "flash_fwd_twin<64>")
        assert entry["designs_in_turns"]["shipped_kernel"] == kernel
    assert [e["launches"] for e in entries] == [32, 16, 16]
    paths["distill_8b_1b"]["flash_bwd_dkv"] = 0
    with pytest.raises(AssertionError, match="launched no kernel"):
        chip_smoke.d64_kernel_entries(numbers, paths, designs)


def test_d64_k1_entry_counts_its_head_dim_alone():
    """The ``flash_fwd d64`` entry counts the launches the paths made at d
    64 (the distillation student's 2 · 16 a step), not all of K1's (the
    teacher's d 128 ones too), and fails when a path made none at d 64."""
    _, numbers, paths, designs = _d64_inputs()
    k1 = chip_smoke.d64_kernel_entries(numbers, paths, designs)[0]
    assert k1["name"] == "flash_fwd d64"
    assert k1["launches"] == 32
    assert k1["launches_by_path"] == {"distill_8b_1b": 32}
    assert k1["designs_in_turns"] is designs[64]["flash_fwd"]
    assert "pair_ms" not in k1
    paths["distill_8b_1b"]["flash_fwd d64"] = 0
    with pytest.raises(AssertionError, match="flash_fwd d64: a path"):
        chip_smoke.d64_kernel_entries(numbers, paths, designs)


def test_k1_launches_split_by_head_dim(monkeypatch):
    """``_k1_by_head_dim`` adds K1's own count (``launches``, bumped where
    the kernel launches; here a stand-in forward bumps it) up by head dim
    for as long as it is open, and puts the forward back after."""
    import torch

    from service_account_auth_improvements_tpu_torch.ops import (
        flash_attention as fa,
    )

    def forward(q, k, v, causal):
        fa.launches += 1
        return fa.flash_fwd_reference(q, k, v, causal)

    monkeypatch.setattr(fa, "_forward", forward)
    monkeypatch.setattr(fa, "launches", 0)
    by_dim = {}
    with chip_smoke._k1_by_head_dim(fa, by_dim):
        for d, n in ((64, 2), (128, 1)):
            q = torch.zeros((1, 2, 8, d))
            for _ in range(n):
                fa.flash_fwd(q, q[:, :1], q[:, :1], True)
    assert by_dim == {64: 2, 128: 1} and fa.launches == 3
    assert fa._forward is forward


@pytest.mark.parametrize("key,d", [("flash_fwd_twin", 64),
                                   ("dq_rows8<192>", 192)])
def test_new_variant_keys_name_their_template_and_shape(key, d):
    """kernel_variants.py's keys for K1 at d 64 (its first head dim, so
    the bare template) and K2 at d 192 name a kernel template of csrc/
    (``template_of``), are timed at the shapes phase_wide_designs times
    those designs at (DESIGN_SHAPES), and have variants, among them the
    other build's design."""
    kernel = kernel_variants.template_of(key)
    assert key in (kernel, f"{kernel}<{d}>")
    assert kernel in _global_kernels()
    assert kernel_variants.source_of(kernel) == (
        "flash_fwd" if kernel.startswith("flash_fwd") else "flash_bwd")
    h, hkv, hd = kernel_variants.KERNEL_HEADS[key]
    assert hd == d
    assert kernel_variants.KERNEL_SHAPES[key] == [
        (*chip_smoke.DESIGN_SHAPES[d][:2], h, hkv, d)]
    assert (h, hkv) == chip_smoke.DESIGN_SHAPES[d][2:]
    edits = [n for n, v in kernel_variants.VARIANTS.items() if v[2] == key]
    assert len(edits) >= 3
    shown = {kernel_variants.VARIANTS[n][-1] for n in edits}
    assert {"flash_fwd_wgmma", "dq_wgmma"} & shown


def test_wide_edges_cover_the_blocks():
    """phase_wide_designs holds the other build's K1 at d 192 and 256 and
    K2 at d 192 at one row, ragged ends inside and past a 128-row block,
    s 2047 and non-causal aligned (BLOCK_Q)."""
    from service_account_auth_improvements_tpu_torch.ops import (
        flash_attention as fa,
    )

    edges = chip_smoke.WIDE_EDGES
    assert {s for _, s, _ in edges} >= {1, 65, 191, 2047}
    assert all(s % fa.BLOCK_Q == 0 for _, s, causal in edges if not causal)
    assert any(not causal for *_, causal in edges)
    h, hkv, _ = chip_smoke.WIDE_HEADS["bench_800m_d192"]
    assert h // hkv == 2


def test_pair_edges_cover_the_blocks():
    """phase 3 and phase_wide_designs hold K3's pairs of blocks at d 320 to
    512 (dkv_pair: 64 keys a pair, 64-query stages) at one row, ragged
    ends past one and two 64-key blocks, s 2047, GQA groups 1 to 3 and
    non-causal aligned, at each dim; the dims are the ones K3 ships the
    pair at, d 320 and 448 among them (the padded halves), each timed in
    turns at DESIGN_SHAPES."""
    edges = chip_smoke.PAIR_EDGES
    lengths = {s for _, s, _, _, _ in edges}
    assert {1, 65, 129, 2047} <= lengths
    assert any(s % 64 not in (0, 1) for s in lengths)  # inside a block
    assert {h // hkv for _, _, h, hkv, _ in edges} == {1, 2, 3}
    assert all(h % hkv == 0 for _, _, h, hkv, _ in edges)
    assert any(not causal and s % 64 == 0 for _, s, _, _, causal in edges)
    assert chip_smoke.PAIR_DIMS == (384, 512)
    assert chip_smoke.DKV_PAIR_DIMS == (320, 384, 448, 512)
    assert set(chip_smoke.PAIR_DIMS) < set(chip_smoke.DKV_PAIR_DIMS)
    assert chip_smoke.PAIR_EDGE_SETS["flash_bwd_dkv"] == edges
    assert set(chip_smoke.DKV_PAIR_DIMS) <= set(chip_smoke.DESIGN_DIMS)
    assert "dkv_pair" in chip_smoke.CLEAN_KERNELS
    for d in chip_smoke.DKV_PAIR_DIMS:
        assert chip_smoke.design_kernels(_Fwd(False), _Bwd(False), d)[
            "flash_bwd_dkv"] == f"dkv_pair<{d}>"
        assert chip_smoke.design_kernels(_Fwd(True), _Bwd(True), d)[
            "flash_bwd_dkv"] == f"dkv_split<{d}>"
    for d in (320, 448):
        assert chip_smoke.DESIGN_SHAPES[d] == (
            chip_smoke.TRAIN_BATCH, chip_smoke.TRAIN_SEQ,
            *chip_smoke.KERNEL_ONLY_HEADS[f"d{d}"][:2])
    src = (ROOT / "chip_smoke.py").read_text()
    assert src.count("for d in DKV_PAIR_DIMS") == 1
    assert '("flash_bwd_dkv", DKV_PAIR_DIMS)' in src


def test_rows_pair_edges_cover_the_blocks():
    """phase 3 and phase_wide_designs hold K1's and K2's pairs of blocks
    (flash_fwd_pair, dq_pair: 128 query rows a pair) at one row, one short
    of and one past a pair, one short of two, s 300 at GQA groups 1 to 3,
    s 1000 and 2047 and non-causal aligned, at every dim either build runs
    a pair at (PAIR_DIMS: each kernel has one at d 384 and 512, K2's at d
    384 in the other build, each held at its own edges in both builds);
    their training shape (b 8 s 2048 at phase 12's heads) is phase 3's
    too."""
    edges = chip_smoke.ROWS_PAIR_EDGES
    lengths = {s for _, s, _, _, _ in edges}
    assert {1, 127, 129, 255, 1000, 2047} <= lengths
    assert {h // hkv for _, s, h, hkv, _ in edges if s == 300} == {1, 2, 3}
    assert all(h % hkv == 0 for _, _, h, hkv, _ in edges)
    assert any(not causal and s % 128 == 0 for _, s, _, _, causal in edges)
    assert not hasattr(chip_smoke, "ROWS_PAIR_DIMS")
    assert chip_smoke.PAIR_EDGE_SETS == {
        "flash_fwd": edges, "flash_bwd_dq": edges,
        "flash_bwd_dkv": chip_smoke.PAIR_EDGES}
    assert set(chip_smoke.PAIR_EDGE_SETS) == set(chip_smoke.KERNELS)
    templates = {"flash_fwd": "flash_fwd_pair", "flash_bwd_dq": "dq_pair",
                 "flash_bwd_dkv": "dkv_pair"}
    for d in chip_smoke.PAIR_DIMS:
        both = {which: chip_smoke.design_kernels(_Fwd(other), _Bwd(other), d)
                for which, other in (("shipped", False), ("other", True))}
        for name, t in templates.items():
            assert f"{t}<{d}>" in {both["shipped"][name], both["other"][name]}
    heads = {d: (h, hkv) for h, hkv, d in chip_smoke.WIDE_HEADS.values()}
    assert set(chip_smoke.PAIR_DIMS) <= set(heads)


def test_clean_kernels_hold_every_pair():
    """Phase 2 fails if a pair of blocks spills or has a C75xx note: K1's,
    K2's and K3's at d 384 and 512, each a kernel of csrc/ with a profile
    group, each launched in clusters with a C function giving the clusters
    a card holds at both dims; and so does each streamed kernel (bf16
    above d 512), which phase 2 finds by its template at its column
    group's width, K3 on a cluster of the key tile's groups and its column
    groups (WIDE_GROUPS) beside it."""
    from service_account_auth_improvements_tpu_torch.ops import (
        flash_attention as fa,
    )

    assert set(chip_smoke.CLEAN_KERNELS) == {
        "flash_fwd_pair", "dq_pair", "dkv_pair",
        *chip_smoke.WIDE_KERNELS.values()}
    assert set(chip_smoke.WIDE_KERNELS) == set(chip_smoke.KERNELS)
    assert chip_smoke.WIDE_GROUPS == {"flash_bwd_dkv": "dkv_wide_groups"}
    wide = (CSRC / f"{chip_smoke.WIDE_SOURCE}.cu").read_text()
    for (name, kernel), const in zip(chip_smoke.WIDE_KERNELS.items(),
                                     ("FWD_W", "DQ_W", "DKV_W")):
        assert kernel in _global_kernels()
        if name in chip_smoke.WIDE_GROUPS:
            groups = chip_smoke.WIDE_GROUPS[name]
            assert groups in _global_kernels()
            assert f"launch_cluster({kernel}<{const}>, blocks, a.groups," in (
                wide)
            assert f"launch({groups}<{const}>, blocks," in wide
            assert chip_smoke._template_name(
                f"_ZN46_GLOBAL__N__0_13_flash_wide_cu_0598c693{len(groups)}"
                f"{groups}ILi{fa.WIDE_COLUMNS[name]}EEEvNS_7ArgsE",
                fa.WIDE_COLUMNS[name]) == groups
        else:
            assert f"launch({kernel}<{const}>," in wide
        assert f"constexpr int {const} = {fa.WIDE_COLUMNS[name]};" in wide
        assert chip_smoke._template_name(
            f"_ZN46_GLOBAL__N__0_13_flash_wide_cu_0598c693{len(kernel)}"
            f"{kernel}ILi{fa.WIDE_COLUMNS[name]}EEEvNS_7ArgsE",
            fa.WIDE_COLUMNS[name]) == kernel
    assert set(chip_smoke.CLEAN_KERNELS) <= _global_kernels()
    assert set(chip_smoke.CLEAN_KERNELS) <= set(chip_smoke.PROFILE_KERNELS)
    text = {name: (CSRC / f"{name}.cu").read_text()
            for name in chip_smoke.KERNEL_SOURCES}
    assert "launch_cluster(flash_fwd_pair<D>" in text["flash_fwd"]
    assert "launch_cluster(dq_pair<D>" in text["flash_bwd"]
    assert 'extern "C" int flash_fwd_clusters(int d)' in text["flash_fwd"]
    assert 'extern "C" int flash_bwd_dq_clusters(int d)' in text[
        "flash_bwd"]
    for fn, source, kernel in (
            ("flash_fwd_clusters", "flash_fwd", "fwd"),
            ("flash_bwd_dq_clusters", "flash_bwd", "dq"),
            ("flash_bwd_dkv_clusters", "flash_bwd", "dkv")):
        body = text[source].split(f'extern "C" int {fn}(int d) {{', 1)[1]
        body = body.split("\n}\n", 1)[0]
        for d in (chip_smoke.DKV_PAIR_DIMS if kernel == "dkv"
                  else chip_smoke.PAIR_DIMS):
            assert f"case {d}: return {kernel}_clusters<{d}>();" in body


@pytest.mark.parametrize("other", [False, True])
def test_design_ids_of_either_build_are_labelled(other):
    """Every id K1's, K2's and K3's design functions return in the shipped
    build or in the -DFLASH_OTHER_DESIGNS=1 one, at every head dim the
    kernels take, has a label (FWD_DESIGNS, BWD_DESIGNS) and a kernel
    template of csrc/ (DESIGN_KERNELS)."""
    from service_account_auth_improvements_tpu_torch.ops import (
        flash_attention as fa,
    )

    fwd, bwd = _Fwd(other), _Bwd(other)
    for d in fa.KERNEL_HEAD_DIMS:
        ids = {"flash_fwd": fwd.flash_fwd_design(d),
               "flash_bwd_dq": bwd.flash_bwd_dq_design(d),
               "flash_bwd_dkv": bwd.flash_bwd_dkv_design(d)}
        for name, i in ids.items():
            labels = (chip_smoke.FWD_DESIGNS if name == "flash_fwd"
                      else chip_smoke.BWD_DESIGNS)
            assert i in labels, (name, d, i)
            assert chip_smoke.DESIGN_KERNELS[name][i] in _global_kernels()
        assert chip_smoke.design_names(fwd, bwd, d)
        assert chip_smoke.design_kernels(fwd, bwd, d)


@pytest.mark.parametrize("key,d,split", [
    ("flash_fwd_pair<384>", 384, "flash_fwd_split"),
    ("flash_fwd_pair<512>", 512, "flash_fwd_split"),
    ("dq_pair<512>", 512, "dq_split"),
    ("dq_pair<384>", 384, "dq_pair")])
def test_rows_pair_variant_keys_name_their_template_and_shape(key, d,
                                                              split):
    """kernel_variants.py's keys for K1's and K2's pairs of blocks at d
    384 and 512 (K2's at d 384 runs in the other build, so its variants
    run it) name their template (``template_of``) and source, are timed
    at the shape phase_wide_designs times the two designs at
    (DESIGN_SHAPES: phase 12's heads at the training shape), and have
    variants, among them the other build's split kernel."""
    kernel = kernel_variants.template_of(key)
    assert key == f"{kernel}<{d}>" and kernel in _global_kernels()
    assert kernel_variants.source_of(kernel) == (
        "flash_fwd" if kernel.startswith("flash_fwd") else "flash_bwd")
    h, hkv, hd = kernel_variants.KERNEL_HEADS[key]
    assert hd == d
    assert (h, hkv) == chip_smoke.DESIGN_SHAPES[d][2:]
    assert kernel_variants.KERNEL_SHAPES[key] == [
        (*chip_smoke.DESIGN_SHAPES[d][:2], h, hkv, d)]
    edits = [n for n, v in kernel_variants.VARIANTS.items() if v[2] == key]
    assert len(edits) >= 3
    assert split in {kernel_variants.VARIANTS[n][-1] for n in edits}


@pytest.mark.parametrize("key,d", [("dkv_pair<512>", 512),
                                   ("dkv_pair<384>", 384),
                                   ("dkv_pair<448>", 448),
                                   ("dkv_pair<320>", 320)])
def test_pair_variant_keys_name_their_template_and_shape(key, d):
    """kernel_variants.py's keys for K3's pair of blocks name the template
    (``template_of``) at each of its head dims, are timed at the shape
    phase_wide_designs times the two designs at (DESIGN_SHAPES: phase 12's
    heads, or KERNEL_ONLY_HEADS' at d 320 and 448, at the training shape),
    and have variants, among them the other build's dkv_split."""
    kernel = kernel_variants.template_of(key)
    assert kernel == "dkv_pair" and key == f"{kernel}<{d}>"
    assert kernel in _global_kernels()
    assert kernel_variants.source_of(kernel) == "flash_bwd"
    h, hkv, hd = kernel_variants.KERNEL_HEADS[key]
    assert hd == d
    assert (h, hkv) == chip_smoke.DESIGN_SHAPES[d][2:]
    assert kernel_variants.KERNEL_SHAPES[key] == [
        (*chip_smoke.DESIGN_SHAPES[d][:2], h, hkv, d)]
    edits = [n for n, v in kernel_variants.VARIANTS.items() if v[2] == key]
    assert len(edits) >= 3
    assert "dkv_split" in {kernel_variants.VARIANTS[n][-1] for n in edits}


def _constexpr(expr, d, dh=None):
    """The value at ``D == d`` (and ``DH == dh``) of one of DkvPair's
    constants: an int, a bool, ``D == n``, ``DH == n``, or right-nested
    ``?:`` of those."""
    expr = expr.strip()
    if " ? " in expr:
        cond, rest = expr.split(" ? ", 1)
        then, other = rest.split(" : ", 1)
        return _constexpr(then if _constexpr(cond, d, dh) else other, d, dh)
    if expr.startswith("D == "):
        return d == int(expr[5:])
    if expr.startswith("DH == "):
        assert dh is not None
        return dh == int(expr[6:])
    if expr in ("true", "false"):
        return expr == "true"
    return int(expr)


def _pair_columns(struct, d):
    """DkvPair's DH at ``D == d``: the head-dim columns each block of the
    pair holds, from the source's expression (integer arithmetic)."""
    expr = re.search(r"int DH = ([^;]*);", struct).group(1)
    assert re.fullmatch(r"[\dD+*/() ]+", expr), expr
    return eval(expr.replace("/", "//"), {"D": d})


@pytest.mark.parametrize("d", [320, 384, 448, 512])
def test_dkv_pair_columns_tile_the_head_dim(d):
    """dkv_pair at d 320 to 512, as csrc/flash_bwd.cu states it: each block
    holds DH columns, a multiple of 64 (whole column blocks of the 128-byte
    swizzle); the block of rank r reads from column r DH (its pointers
    moved there), rank 0 its DH columns and rank 1 the d - DH left, so the
    two tile [0, d) with no overlap; rank 1's box is DH wide all the same
    (at d 320 and 448 its last 64 columns are TMA's zeros) and its stores
    stop at d - DH; K and V, the Q and dO stages with their lse and delta,
    the two receive buffers and the mbarriers fit 227 KB; the stages and
    the prefetch follow DH, so d 320 runs d 384's and d 448 d 512's."""
    source = (CSRC / "flash_bwd.cu").read_text()
    struct = source[source.index("struct DkvPair {"):]
    struct = struct[:struct.index("\n};\n")]
    dh = _pair_columns(struct, d)
    const = {name: _constexpr(re.search(rf"{kind} {name} = ([^;]*);",
                                        struct).group(1), d, dh)
             for kind, name in (("int", "BK"), ("int", "BQ"),
                                ("int", "STAGES"), ("bool", "PREFETCH"))}
    assert dh % 64 == 0 and dh <= 256
    args = source[source.index("cudaError_t dkv_pair_args("):]
    args = args[:args.index("\n}\n")]
    assert "hopper::at_column(p, int64_t{r} * L::DH," in args
    assert "batch, r == 0 ? L::DH : D - L::DH, L::DH))" in args
    kernel = source[source.index("dkv_pair(const __grid_constant__"):]
    assert "rank == 0 ? DH : D - DH);" in kernel[:kernel.index("\n}\n")]
    covered = []
    for r in range(2):
        first, real = r * dh, dh if r == 0 else d - dh
        assert 0 < real <= dh
        covered += range(first, first + real)
    assert covered == list(range(d))
    assert (d - dh < dh) == (d in (320, 448))
    smem_max = int(re.search(r"SMEM_MAX = (\d+);", source).group(1))
    assert smem_max == 227 * 1024
    assert "using X = hopper::PairExchange<BQ / 8, 2 * WG>;" in struct
    bq, stages = const["BQ"], const["STAGES"]
    smem = (2 * const["BK"] * dh * 2 + 2 * stages * bq * dh * 2
            + 2 * stages * bq * 4 + 2 * (bq // 8) * 16 * 128
            + 8 * (1 + 2 * stages + 3) + 1024)
    assert smem <= smem_max
    assert (stages, const["PREFETCH"]) == {192: (3, True),
                                           256: (2, False)}[dh]


@pytest.mark.parametrize("variant", [None, *sorted(
    n for n, v in kernel_variants.VARIANTS.items()
    if kernel_variants.template_of(v[2]) == "dkv_pair")])
def test_pair_prefetch_on_two_stages_waits_for_its_refill(variant):
    """dkv_pair's prefetch reads the next stage's tile before the exchange
    barrier that a deferred refill waits for: on two stages that
    deadlocks unless the first warp waits for the refill (the
    PAIR_PREFETCH_WAIT edit). The committed source (None) and every
    variant at its head dim either keep the prefetch off two stages or
    carry the wait."""
    files = kernel_variants.committed_files("flash_bwd")
    d = 384
    if variant is not None:
        files = kernel_variants.variant_files(variant, files)
        d = kernel_variants.KERNEL_HEADS[kernel_variants.VARIANTS[variant][2]][2]
    source = files["flash_bwd.cu"]
    struct = source[source.index("struct DkvPair {"):]
    for dim in {d, *chip_smoke.DKV_PAIR_DIMS}:
        dh = _pair_columns(struct, dim)
        prefetch = _constexpr(
            re.search(r"bool PREFETCH = (.*);", struct).group(1), dim, dh)
        stages = _constexpr(
            re.search(r"int STAGES = ([^;]*);", struct).group(1), dim, dh)
        waits = "if (L::PREFETCH && STAGES == 2)" in source
        assert stages >= 2
        assert waits or not (prefetch and stages == 2), dim


def test_wide_entries_carry_designs_and_pair():
    """The wide head dims' ``kernels`` entries: every key the line's
    contract names, launches summed over phase 12's paths; wherever the
    two builds run different kernels (all three at d 192, 256, 384 and
    512) the designs timed in turns, and K2's
    and K3's the pair's sum beside SDPA's backward; at d 768 the streamed
    kernel, its source csrc/flash_wide.cu, and its recompute factor, K3's
    with both its designs in turns at d 768 and 2048 (a cluster against
    the column groups); the split kernels' kernel-only dims under d 512,
    each naming the kernel it ran, K3's (the pair, dkv_split in the other
    build) with both designs in turns, the streamed kernels' under d
    768."""
    keys = ("shape", "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "library_backend", "tflops", "bound_share")
    labels = {**chip_smoke.WIDE_HEADS, **chip_smoke.KERNEL_ONLY_HEADS}
    numbers = {}
    for name in chip_smoke.KERNELS:
        numbers[name] = {"wide": {}}
        for i, (label, (_, _, d)) in enumerate(labels.items()):
            n = {key: float(i + 1) for key in keys}
            if name != "flash_fwd":
                n["pair_ms"] = 2.0 * (i + 1)
            n.update(chip_smoke.streamed_numbers(name, d))
            numbers[name]["wide"][label] = n
    wide = {d: {"training": {name: 20 for name in chip_smoke.KERNELS},
                "serving": {name: 0 for name in chip_smoke.KERNELS}}
            for _, _, d in chip_smoke.WIDE_HEADS.values()}
    kernels = {d: {which: chip_smoke.design_kernels(
        _Fwd(which == "other"), _Bwd(which == "other"), d)
        for which in ("shipped", "other")}
        for d in chip_smoke.DESIGN_DIMS}
    # as phase_wide_designs returns them: K2 and K3 at every dim, K1
    # only where the two builds run different kernels
    designs = {d: {name: {"shipped_ms": 1.0, "other_ms": 2.0,
                          "shipped_kernel": kernels[d]["shipped"][name],
                          "other_kernel": kernels[d]["other"][name]}
                   for name in chip_smoke.KERNELS
                   if name != "flash_fwd" or kernels[d]["shipped"][name]
                   != kernels[d]["other"][name]}
               for d in chip_smoke.DESIGN_DIMS}
    assert "flash_fwd" not in designs[320] | designs[448]
    for d in chip_smoke.F32_CLUSTER_DIMS:
        designs[d] = {"flash_bwd_dkv": {
            "shipped_ms": 1.0, "other_ms": 2.0,
            "shipped_kernel": "dkv_wide<256>",
            "other_kernel": "dkv_wide_groups<256>"}}
    entries = chip_smoke.wide_kernel_entries(numbers, wide, designs)
    assert len(entries) == len(chip_smoke.WIDE_HEADS) * len(
        chip_smoke.KERNELS)
    contract = {"name", "route", "source", "replaces", "launches",
                "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms"}
    for entry in entries:
        assert contract <= set(entry)
        assert entry["route"] == "cuda" and entry["launches"] == 20
        d = int(entry["name"].rsplit("d", 1)[1])
        kernel = entry["name"].split()[0]
        assert ("designs_in_turns" in entry) == (
            d in (192, 256, 384, 512) or (d, kernel) == (768, "flash_bwd_dkv"))
        assert ("pair_ms" in entry) == (kernel != "flash_fwd")
        assert ("more_shapes" in entry) == (d in (512, 768))
        assert ("recompute" in entry) == (d == 768)
        if d == 768 and "designs_in_turns" in entry:
            assert entry["designs_in_turns"] == {
                f"d{dim}": designs[dim][kernel]
                for dim in chip_smoke.F32_CLUSTER_DIMS}
        elif "designs_in_turns" in entry:
            assert entry["designs_in_turns"] is designs[d][kernel]
        only = {label for label, (_, _, x) in
                chip_smoke.KERNEL_ONLY_HEADS.items() if (x > 512) == (d > 512)}
        if d == 512:
            assert set(entry["more_shapes"]) == only == {"d320", "d448"}
            # K2's and K3's with the kernel each ran; K3's pair with both
            # designs
            for label, n in entry["more_shapes"].items():
                turns = designs[int(label[1:])].get(kernel)
                assert ("kernel" in n) == (turns is not None) == (
                    kernel != "flash_fwd")
                assert ("designs_in_turns" in n) == (
                    kernel == "flash_bwd_dkv")
                if turns is not None:
                    assert n["kernel"] == turns["shipped_kernel"]
                if kernel == "flash_bwd_dkv":
                    assert n["kernel"] == f"dkv_pair<{label[1:]}>"
                    assert n["designs_in_turns"] is turns
        if d == 768:
            assert entry["source"].endswith("/csrc/flash_wide.cu")
            assert entry["kernel"] == (
                f"{chip_smoke.WIDE_KERNELS[kernel]}<256>")
            assert entry["recompute"] == chip_smoke.recompute(768, kernel)
            assert set(entry["more_shapes"]) == only == {
                "d576", "d640", "d704", "d1024", "d2048"}
            for n in entry["more_shapes"].values():
                assert {"kernel", "recompute", *keys} <= set(n)
        else:
            assert entry["source"].endswith(
                f"/csrc/{chip_smoke.KERNELS[kernel][0]}")


def test_recompute_factors_of_the_streamed_kernels():
    """The work of a streamed kernel over its function's: K1 at d 768
    forms S in each of 3 groups over all 768 columns and P V over 256, so
    (3 + 1) / 2 = 2x; a last group narrower than 256 still multiplies 256
    columns (zeros past d), so d 576 costs more than d 768; at multiples
    of 256 more groups cost more; phase 3 records the factor only above
    f32's bound. The bf16 K3 runs on a cluster up to d 2048 (each score
    formed once: 1.0) where its last block holds at least 192 columns, and
    as column groups elsewhere (S^T and dP^T over d, two products over
    W)."""
    assert chip_smoke.recompute(768, "flash_fwd") == 2.0
    # K2: S and dP over d, dS K over W
    assert chip_smoke.recompute(768, "flash_bwd_dq") == 3 * (2 * 768 + 256) / (
        3 * 768)
    assert chip_smoke.recompute(576, "flash_fwd") == 3 * (576 + 256) / 1152
    for kernel in ("flash_fwd", "flash_bwd_dq"):
        factors = [chip_smoke.recompute(d, kernel)
                   for d in (768, 1024, 2048)]
        assert all(f > 1 for f in factors)
        assert factors == sorted(factors)
        assert chip_smoke.recompute(576, kernel) > factors[0]
    for d in (704, 768, 1024, 2048):
        assert chip_smoke.recompute(d, "flash_bwd_dkv") == 1.0
        assert chip_smoke.streamed_numbers("flash_bwd_dkv", d) == {
            "kernel": "dkv_wide<256>", "recompute": 1.0,
            "cluster": -(-d // 256)}
    for d in (576, 640, 2112):
        groups = -(-d // 256)
        assert chip_smoke.recompute(d, "flash_bwd_dkv") == groups * (
            2 * d + 2 * 256) / (4 * d)
        assert chip_smoke.streamed_numbers("flash_bwd_dkv", d) == {
            "kernel": "dkv_wide_groups<256>",
            "recompute": chip_smoke.recompute(d, "flash_bwd_dkv"),
            "cluster": 1}
    for kernel in chip_smoke.KERNELS:
        assert chip_smoke.streamed_numbers(kernel, 512) == {}
        if kernel != "flash_bwd_dkv":
            assert chip_smoke.streamed_numbers(kernel, 1024) == {
                "kernel": f"{chip_smoke.WIDE_KERNELS[kernel]}<256>",
                "recompute": chip_smoke.recompute(1024, kernel),
                "cluster": 1}


def test_streamed_numbers_name_the_f32_kernels():
    """Above the per-dim bound phase 3 records, beside an f32 timing, the
    streamed f32 kernel at its group's width, its recompute factor and its
    cluster: K1, K2 and K3 a cluster of ceil(d / 256) blocks up to d 2048
    (each score formed once, each block multiplying only its own columns:
    1.0, a last narrower block too), and the column groups past it (bf16's
    factor: each group forms the whole head dim's scores); nothing up to
    the bound."""
    import torch

    assert set(chip_smoke.WIDE_F32_KERNELS) == set(chip_smoke.KERNELS)
    assert set(chip_smoke.WIDE_F32_GROUPS) == set(chip_smoke.KERNELS)
    for kernel, template in chip_smoke.WIDE_F32_KERNELS.items():
        assert template == f"{chip_smoke.WIDE_KERNELS[kernel]}_f32"
        assert chip_smoke.WIDE_F32_GROUPS[kernel] == f"{template}_groups"
        for d in (576, 768, 832, 1024, 2048, 2112):
            clustered = d <= 2048
            want = {"kernel": f"{template}<256>",
                    "recompute": 1.0 if clustered
                    else chip_smoke.recompute(d, kernel),
                    "cluster": -(-d // 256) if clustered else 1}
            if d > 2048:
                want["kernel"] = (f"{chip_smoke.WIDE_F32_GROUPS[kernel]}"
                                  "<256>")
            assert chip_smoke.streamed_numbers(kernel, d,
                                               torch.float32) == want
            assert chip_smoke.recompute(d, kernel, torch.float32) == (
                want["recompute"])
            if kernel != "flash_bwd_dkv":
                assert chip_smoke.streamed_numbers(kernel, d) == {
                    "kernel": f"{chip_smoke.WIDE_KERNELS[kernel]}<256>",
                    "recompute": chip_smoke.recompute(d, kernel),
                    "cluster": 1}
        assert chip_smoke.streamed_numbers(kernel, 512, torch.float32) == {}
    assert chip_smoke.recompute(768, "flash_fwd") == 2.0
    assert chip_smoke.recompute(768, "flash_fwd", torch.float32) == 1.0
    assert chip_smoke.recompute(2048, "flash_bwd_dq") == 8 * (
        2 * 2048 + 256) / (3 * 2048)
    assert chip_smoke.streamed_numbers(
        "flash_bwd_dkv", 576, torch.float32)["cluster"] == 3
    assert chip_smoke._streamed_dims() == [768, 576, 640, 704, 1024, 2048]
    assert all(d > chip_smoke.PER_DIM_MAX for d in chip_smoke._streamed_dims())


def _wide_f32_numbers():
    """Fake phase 3 numbers for the streamed f32 kernels at every
    streamed head dim, as phase_kernels and phase_bwd_kernels record
    them."""
    import torch

    keys = ("shape", "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "library_backend", "tflops", "bound_share")
    numbers = {}
    for name in chip_smoke.KERNELS:
        numbers[name] = {"f32_wide": {}}
        for i, (label, (_, _, d)) in enumerate(
                chip_smoke._kernel_heads().items()):
            if d <= chip_smoke.PER_DIM_MAX:
                continue
            n = {key: float(i + 1) for key in keys}
            if name != "flash_fwd":
                n["pair_ms"] = 2.0 * (i + 1)
            n.update(chip_smoke.streamed_numbers(name, d, torch.float32))
            numbers[name]["f32_wide"][label] = n
    return numbers


def _wide_f32_designs():
    """Fake phase_f32_designs numbers of the streamed f32 K1, K2 and K3 at
    F32_CLUSTER_DIMS, and phase 2's ptxas numbers of every streamed f32
    kernel in either build."""
    streamed = {d: {name: {"shipped_design": chip_smoke.F32_DESIGNS[2],
                           "other_design": chip_smoke.F32_DESIGNS[1],
                           "shipped_ms": 1.0, "other_ms": 2.0,
                           "shipped_clusters": 39 if d == 768 else 15,
                           "other_clusters": -1}
                    for name in chip_smoke.WIDE_F32_GROUPS}
                for d in chip_smoke.F32_CLUSTER_DIMS}
    ptxas = {(which, kernel): {"registers": 200 + i, "spill_stores": 0,
                               "notes": []}
             for which in ("shipped", "other")
             for i, kernel in enumerate((
                 *chip_smoke.WIDE_F32_KERNELS.values(),
                 *chip_smoke.WIDE_F32_GROUPS.values()))}
    return {"streamed": streamed}, ptxas


def test_wide_f32_entries_carry_recompute_and_paths():
    """The streamed f32 kernels' ``kernels`` entries: one per kernel at
    bench_800m_d768's heads, every key the line's contract names, source
    csrc/flash_wide.cu, the f32 kernel, its recompute factor and cluster,
    its registers and spills, the kernel-only dims under ``more_shapes``,
    launches summed over the paths that ran each kernel (K1 also the f32
    greedy decode); K2's and K3's also their design, the clusters a card
    holds and both designs in turns at F32_CLUSTER_DIMS (K1's too); a path that
    launched none of a kernel raises."""
    numbers = _wide_f32_numbers()
    designs, ptxas = _wide_f32_designs()
    paths = {"flash vs dense grads d768": {"flash_fwd": 40,
                                            "flash_bwd_dq": 20,
                                            "flash_bwd_dkv": 20},
             "greedy f32 d768": {"flash_fwd": 20}}
    entries = chip_smoke.wide_f32_kernel_entries(numbers, paths, designs,
                                                 ptxas)
    assert [e["name"] for e in entries] == [
        f"{name} f32 d768" for name in chip_smoke.KERNELS]
    contract = {"name", "route", "source", "replaces", "launches",
                "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms"}
    for entry, (name, (_, _, line)) in zip(entries,
                                           chip_smoke.KERNELS.items()):
        assert contract <= set(entry) and entry["route"] == "cuda"
        assert entry["source"].endswith("/csrc/flash_wide.cu")
        assert entry["replaces"].endswith(f"flash_attention.py:{line}")
        kernel = chip_smoke.WIDE_F32_KERNELS[name]
        assert entry["kernel"] == f"{kernel}<256>"
        assert entry["registers"] == ptxas["shipped", kernel]["registers"]
        assert entry["spill_stores"] == 0
        assert ("pair_ms" in entry) == (name != "flash_fwd")
        assert entry["recompute"] == 1.0 and entry["cluster"] == 3
        assert entry["design"] == chip_smoke.F32_DESIGNS[2]
        assert entry["clusters_a_card"] == 39
        assert entry["designs_in_turns"] == {
            f"d{d}": designs["streamed"][d][name]
            for d in chip_smoke.F32_CLUSTER_DIMS}
        want = {path: n[name] for path, n in paths.items() if name in n}
        assert entry["launches_by_path"] == want
        assert entry["launches"] == sum(want.values())
        assert set(entry["more_shapes"]) == {
            "d576", "d640", "d704", "d1024", "d2048"}
        for n in entry["more_shapes"].values():
            assert {"kernel", "recompute", "cluster", "ms",
                    "bound_ms"} <= set(n)
        assert entry["more_shapes"]["d2048"]["cluster"] == 8
    assert entries[0]["launches"] == 60 and entries[1]["launches"] == 20
    paths["greedy f32 d768"]["flash_fwd"] = 0
    with pytest.raises(AssertionError, match="launched no kernel"):
        chip_smoke.wide_f32_kernel_entries(numbers, paths, designs, ptxas)
    with pytest.raises(AssertionError, match="launched no kernel"):
        chip_smoke.wide_f32_kernel_entries(numbers, {}, designs, ptxas)


def test_streamed_f32_kernels_are_held_clean():
    """Phase 2 fails if a streamed f32 kernel spills or has a C75xx note,
    in either build: it finds each by its template at the column group's
    width in the ptxas report (the mangled name of an ``F32Args`` kernel),
    their column groups (WIDE_F32_GROUPS) too; each is launched at the
    source's constant, which is WIDE_COLUMNS, on a cluster of the row
    tile's groups. Their variants run the exchange's rounds in a row (the
    overlap they time); all at d 768 and 2048."""
    from service_account_auth_improvements_tpu_torch.ops import (
        flash_attention as fa,
    )

    wide = (CSRC / f"{chip_smoke.WIDE_SOURCE}.cu").read_text()
    launches = {"flash_fwd": "launch_cluster(flash_fwd_wide_f32<FWD_W_F32>, "
                             "blocks, a.groups,",
                "flash_bwd_dq": "launch_cluster(dq_wide_f32<DQ_W_F32>, "
                                "blocks, a.groups,",
                "flash_bwd_dkv": "launch_cluster(dkv_wide_f32<DKV_W_F32>, "
                                 "blocks, a.groups,"}
    for (name, kernel), const in zip(chip_smoke.WIDE_F32_KERNELS.items(),
                                     ("FWD_W_F32", "DQ_W_F32", "DKV_W_F32")):
        assert kernel in _global_kernels()
        assert launches[name] in wide
        groups = chip_smoke.WIDE_F32_GROUPS[name]
        assert groups in _global_kernels()
        assert f"launch({groups}<{const}>, blocks," in wide
        w = fa.WIDE_COLUMNS[name]
        assert f"constexpr int {const} = {w};" in wide
        for template in (kernel, groups):
            mangled = (f"_ZN46_GLOBAL__N__687d0614_13_flash_wide_cu_0598c693"
                       f"{len(template)}{template}ILi{w}EEEvNS_7F32ArgsE")
            assert chip_smoke._template_name(mangled, w) == template
            report = ("ptxas info    : Compiling entry function "
                      f"'{mangled}' for 'sm_90a'\n"
                      "ptxas info    : Function properties for x\n"
                      "    0 bytes stack frame, 0 bytes spill stores, 0 "
                      "bytes spill loads\nptxas info    : Used 244 "
                      "registers\n")
            assert chip_smoke.ptxas_summary(report) == {mangled: {
                "registers": 244, "spill_stores": 0, "notes": []}}
        variant = kernel_variants.VARIANTS[f"{kernel}_in_line"]
        (old, new), = variant[1]
        product = "pv(" if name == "flash_fwd" else "product("
        assert old.count("xc.") == new.count("xc.") == 3
        assert old.index(product) < old.index("xc.collect(")
        assert new.index(product) > new.index("xc.collect(")
        assert variant[2] == kernel
        assert kernel_variants.source_of(kernel) == chip_smoke.WIDE_SOURCE
        assert kernel_variants.KERNEL_HEADS[kernel] == chip_smoke.WIDE_HEADS[
            "bench_800m_d768"]
        assert [s[-1] for s in kernel_variants.KERNEL_SHAPES[kernel]] == [
            768, 2048]


def test_f32_design_labels_name_every_design():
    """chip_smoke.py labels each id of K1's, K2's and K3's f32 design
    functions, and no other; each source's rule: in the per-dim sources
    the register-tiled kernels at every head dim, the scalar ones at d 128
    in a -DFLASH_OTHER_DESIGNS=1 build (F32_DESIGN_DIM, the dim
    phase_f32_designs times in turns); in the streamed source K1, K2 and
    K3 a cluster up to CLUSTER_MAX groups and the column groups past it
    and in the other build (all named by ``wide_f32_designs``)."""
    assert chip_smoke.F32_DESIGNS == {
        0: "scalar", 1: "register-tiled",
        2: "register-tiled on a cluster of ceil(d / 256) blocks"}
    assert chip_smoke.F32_DESIGN_DIM == 128
    labelled = set()
    for source, fn in (("flash_fwd", "flash_fwd_f32_design"),
                       ("flash_bwd", "flash_bwd_f32_design")):
        ids = _designs(source, "F32Design")
        assert ids == {"kF32Scalar": 0, "kF32Tiled": 1}
        labelled |= set(ids.values())
        text = (CSRC / f"{source}.cu").read_text()
        rule = re.search(r"constexpr int f32_design\(int d\) \{(.*?)\}",
                         text, re.S).group(1)
        assert " ".join(rule.split()) == (
            "return FLASH_OTHER_DESIGNS && d == 128 ? kF32Scalar : "
            "kF32Tiled;")
        assert (f'extern "C" int {fn}(int d) {{ return f32_design(d); }}'
                in text)
    wide_ids = _designs(chip_smoke.WIDE_SOURCE, "F32Design")
    assert wide_ids == {"kF32Tiled": 1, "kF32Cluster": 2}
    assert wide_ids["kF32Cluster"] == chip_smoke.F32_CLUSTER_DESIGN
    assert labelled | set(wide_ids.values()) == set(chip_smoke.F32_DESIGNS)
    wide = (CSRC / f"{chip_smoke.WIDE_SOURCE}.cu").read_text()
    rule = re.search(r"constexpr int f32_design\(int kernel, int d\) \{"
                     r"(.*?)\}", wide, re.S).group(1)
    assert " ".join(rule.split()) == (
        "return FLASH_OTHER_DESIGNS || (d + DQ_W_F32 - 1) / "
        "DQ_W_F32 > CLUSTER_MAX ? kF32Tiled : kF32Cluster;")

    class Lib:
        def __init__(self, other):
            self.flash_fwd_f32_design = self.flash_bwd_f32_design = (
                lambda d: ids["kF32Scalar" if other and d == 128
                              else "kF32Tiled"])

    names = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
    for d in (64, 128, 512):
        assert chip_smoke.f32_design_names(Lib(False), Lib(False), d) == (
            dict.fromkeys(names, "register-tiled"))
    assert chip_smoke.f32_design_names(Lib(True), Lib(True), 128) == (
        dict.fromkeys(names, "scalar"))
    assert chip_smoke.f32_design_names(Lib(True), Lib(True), 256) == (
        dict.fromkeys(names, "register-tiled"))

    class Wide:
        def __init__(self, other):
            self.other = other

        def flash_wide_f32_design(self, kernel, d):
            return 1 if self.other or d > 2048 else 2

        def flash_wide_f32_clusters(self, kernel, d):
            return -1 if self.flash_wide_f32_design(kernel, d) == 1 else 39

    for d in (768, 2048):
        assert chip_smoke.wide_f32_designs(Wide(False), d) == {
            name: {"design": chip_smoke.F32_DESIGNS[2],
                   "kernel": f"{chip_smoke.WIDE_F32_KERNELS[name]}<256>",
                   "clusters": 39}
            for name in chip_smoke.KERNELS}
    for lib, d in ((Wide(True), 768), (Wide(False), 2112)):
        assert chip_smoke.wide_f32_designs(lib, d) == {
            name: {"design": chip_smoke.F32_DESIGNS[1],
                   "kernel": f"{chip_smoke.WIDE_F32_GROUPS[name]}<256>",
                   "clusters": -1}
            for name in chip_smoke.KERNELS}


def test_wide_design_labels_name_every_design():
    """chip_smoke.py labels each id of the streamed source's bf16 design
    function (flash_wide_design: WideDesign), and no other; the other
    build's rule runs the column groups everywhere; ``wide_designs`` names
    K3's cluster (dkv_wide) or column groups (dkv_wide_groups) by it, with
    the clusters a card holds, and K1's and K2's column groups
    (flash_fwd_wide, dq_wide) at every d. phase_wide_designs times K3's
    two designs at F32_CLUSTER_DIMS (``_streamed_k3_designs``)."""
    ids = _designs(chip_smoke.WIDE_SOURCE, "WideDesign")
    assert ids == {"kWideGroups": 1, "kWideCluster": 2}
    assert set(ids.values()) == set(chip_smoke.WIDE_DESIGNS)
    assert ids["kWideCluster"] == chip_smoke.WIDE_CLUSTER_DESIGN
    wide = (CSRC / f"{chip_smoke.WIDE_SOURCE}.cu").read_text()
    for fn in ("flash_wide_design", "flash_wide_clusters"):
        assert f'extern "C" int {fn}(int kernel, int d) {{' in wide
    assert chip_smoke.F32_CLUSTER_DIMS == (768, 2048)
    assert "out.update(_streamed_k3_designs(libs, bwd, gen))" in (
        ROOT / "chip_smoke.py").read_text()

    class Wide:
        def __init__(self, other):
            self.other = other

        def flash_wide_design(self, kernel, d):
            return 2 if kernel == 2 and not self.other and d <= 2048 else 1

        def flash_wide_clusters(self, kernel, d):
            return 44 if self.flash_wide_design(kernel, d) == 2 else -1

    for lib, d in ((Wide(False), 768), (Wide(False), 2048),
                   (Wide(True), 768), (Wide(False), 2112)):
        got = chip_smoke.wide_designs(lib, d)
        cluster = not lib.other and d <= 2048
        assert got["flash_bwd_dkv"] == {
            "design": chip_smoke.WIDE_DESIGNS[2 if cluster else 1],
            "kernel": "dkv_wide<256>" if cluster else "dkv_wide_groups<256>",
            "clusters": 44 if cluster else -1}
        for name in ("flash_fwd", "flash_bwd_dq"):
            assert got[name] == {
                "design": chip_smoke.WIDE_DESIGNS[1],
                "kernel": f"{chip_smoke.WIDE_KERNELS[name]}<256>",
                "clusters": -1}


def test_f32_settings():
    """Phase 3 times K1, K2 and K3 in f32 at bench_800m's heads at s 1000
    and at the training shape and at phase 12's d 256 and d 512 heads, the
    first two also in turns with the scalar design; phase 2 reports ptxas
    for kernels the sources define, each kernel's two designs among them,
    and holds the register-tiled ones to no spill."""
    from service_account_auth_improvements_tpu_torch.ops import (
        flash_attention as fa,
    )

    assert chip_smoke.F32_SHAPES == {
        "b2 s1000 h12 hkv4 d128": (2, 1000, 12, 4, 128),
        "b8 s2048 h12 hkv4 d128": (8, 2048, 12, 4, 128),
        "b2 s1000 h6 hkv2 d256": (2, 1000, 6, 2, 256),
        "b2 s1000 h3 hkv1 d512": (2, 1000, 3, 1, 512)}
    assert chip_smoke.F32_IN_TURNS == 2
    for label, (b, s, h, hkv, d) in chip_smoke.F32_SHAPES.items():
        assert label == f"b{b} s{s} h{h} hkv{hkv} d{d}"
        assert d in fa.KERNEL_HEAD_DIMS
    for _, _, _, _, d in list(chip_smoke.F32_SHAPES.values())[
            :chip_smoke.F32_IN_TURNS]:
        assert d == chip_smoke.F32_DESIGN_DIM
    assert (chip_smoke.WIDE_HEADS["bench_800m_d256"]
            == chip_smoke.F32_SHAPES["b2 s1000 h6 hkv2 d256"][2:])
    assert (chip_smoke.WIDE_HEADS["bench_800m_d512"]
            == chip_smoke.F32_SHAPES["b2 s1000 h3 hkv1 d512"][2:])
    kernels = _global_kernels()
    assert set(chip_smoke.F32_KERNELS) <= kernels
    assert set(chip_smoke.F32_NO_SPILL) <= set(chip_smoke.F32_KERNELS)
    assert not any(k.endswith("_scalar") for k in chip_smoke.F32_NO_SPILL)
    for k in ("flash_fwd_f32", "dq_f32", "dkv_f32"):
        assert k in chip_smoke.F32_NO_SPILL
        assert f"{k}_scalar" in chip_smoke.F32_KERNELS


def _f32_numbers(keys):
    numbers = {}
    for name in chip_smoke.KERNELS:
        numbers[name] = {"f32": {
            label: {key: float(i + 1) for key in keys
                    if name != "flash_fwd" or key != "pair_ms"}
            for i, label in enumerate(chip_smoke.F32_SHAPES)}}
    return numbers


def test_f32_entries_carry_designs_and_pair():
    """K1's, K2's and K3's f32 ``kernels`` entries: every key the line's
    contract names, the first F32_SHAPES shape's numbers with the others
    under more_shapes, launches summed over the f32 paths, the designs
    timed in turns and (K2, K3) the pair's sum; a path that launched
    nothing fails."""
    keys = ("shape", "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "library_backend", "tflops", "bound_share",
            "pair_ms")
    numbers = _f32_numbers(keys)
    labels = list(chip_smoke.F32_SHAPES)[:chip_smoke.F32_IN_TURNS]
    designs = {label: {name: {"shipped_ms": 1.0, "other_ms": 5.0}
                       for name in chip_smoke.KERNELS}
               for label in labels}
    paths = {"flash vs dense grads d128": {"flash_fwd": 20,
                                           "flash_bwd_dq": 20,
                                           "flash_bwd_dkv": 20},
             "pipeline step 1 f32": {"flash_fwd": 60, "flash_bwd_dq": 60,
                                     "flash_bwd_dkv": 60}}
    entries = chip_smoke.f32_kernel_entries(numbers, designs, paths)
    assert [e["name"] for e in entries] == ["flash_fwd f32",
                                            "flash_bwd_dq f32",
                                            "flash_bwd_dkv f32"]
    contract = {"name", "route", "source", "replaces", "launches",
                "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms"}
    for entry in entries:
        kernel = entry["name"].split()[0]
        assert contract <= set(entry)
        assert entry["route"] == "cuda" and entry["launches"] == 80
        assert entry["source"].endswith(
            f"csrc/{chip_smoke.KERNELS[kernel][0]}")
        assert entry["replaces"].endswith(
            f"flash_attention.py:{chip_smoke.KERNELS[kernel][2]}")
        assert entry["ms"] == 1.0
        assert entry.get("pair_ms") == (
            None if kernel == "flash_fwd" else 1.0)
        assert set(entry["more_shapes"]) == set(chip_smoke.F32_SHAPES) - {
            labels[0]}
        assert entry["designs_in_turns"] == {
            label: designs[label][kernel] for label in labels}
    paths["moe flash vs dense grads"] = {"flash_fwd": 24, "flash_bwd_dq": 0,
                                         "flash_bwd_dkv": 0}
    with pytest.raises(AssertionError, match="launched no kernel"):
        chip_smoke.f32_kernel_entries(numbers, designs, paths)


@pytest.mark.parametrize("mangled,name", [
    ("_ZN45_GLOBAL__N__eed8c072_12_flash_bwd_cu_3c15cd286dq_f32ILi128EEEvNS_"
     "6ParamsE", "dq_f32"),
    ("_ZN45_GLOBAL__N__eed8c072_12_flash_bwd_cu_3c15cd287dkv_f32ILi128EEEvNS"
     "_6ParamsEPfi", "dkv_f32"),
    ("_ZN45_GLOBAL__N__eed8c072_12_flash_bwd_cu_3c15cd2810f32_reduceILi128E"
     "Lb1EEEvNS_6ParamsEPKfii", "f32_reduce"),
    ("_ZN45_GLOBAL__N__eed8c072_12_flash_bwd_cu_3c15cd2813dq_f32_scalarILi12"
     "8EEEvNS_6ParamsE", "dq_f32_scalar"),
    ("_ZN45_GLOBAL__N__d1e5a3b0_12_flash_fwd_cu_4f0a9c1213flash_fwd_f32ILi12"
     "8EEEvNS_6ParamsE", "flash_fwd_f32"),
    ("_ZN45_GLOBAL__N__d1e5a3b0_12_flash_fwd_cu_4f0a9c1220flash_fwd_f32_scal"
     "arILi128EEEvNS_6ParamsE", "flash_fwd_f32_scalar")])
def test_template_name_reads_f32_kernels(mangled, name):
    """phase 2's f32 lines name each f32 kernel at its head dim (the
    namespace's hash ends in a digit that runs into the name's length)."""
    assert name in chip_smoke.F32_KERNELS
    assert chip_smoke._template_name(mangled, 128) == name
    assert chip_smoke._template_name(mangled, 256) is None


@pytest.mark.parametrize("mangled,name,d", [
    ("_ZN45_GLOBAL__N__75498264_12_flash_fwd_cu_b294bfd014flash_fwd_pairILi38"
     "4EEEvNS_11FwdPairArgsE", "flash_fwd_pair", 384),
    ("_ZN45_GLOBAL__N__75498264_12_flash_fwd_cu_b294bfd014flash_fwd_pairILi51"
     "2EEEvNS_11FwdPairArgsE", "flash_fwd_pair", 512),
    ("_ZN45_GLOBAL__N__eed8c072_12_flash_bwd_cu_3c15cd287dq_pairILi512EEEvNS_"
     "10DqPairArgsE", "dq_pair", 512),
    ("_ZN45_GLOBAL__N__eed8c072_12_flash_bwd_cu_3c15cd287dq_pairILi384EEEvNS_"
     "10DqPairArgsE", "dq_pair", 384),
    ("_ZN45_GLOBAL__N__eed8c072_12_flash_bwd_cu_3c15cd288dkv_pairILi384EEEvN"
     "S_11DkvPairArgsE", "dkv_pair", 384)])
def test_template_name_reads_pair_kernels(mangled, name, d):
    """phase 2's lines name each pair of blocks at its head dim (the
    namespace's hash ends in a digit that runs into the name's length), so
    CLEAN_KERNELS holds them."""
    assert name in chip_smoke.CLEAN_KERNELS
    assert chip_smoke._template_name(mangled, d) == name
    assert chip_smoke._template_name(mangled, 256) is None


def test_ptxas_summary_reads_registers_spills_and_notes():
    """phase_build's one line per d 256 kernel: registers, spill stores
    and the C75xx notes, from ptxas's report (a C7512 note comes before
    the entry function it names)."""
    k2 = ("_ZN45_GLOBAL__N__eed8c072_12_flash_bwd_cu_3c15cd288dq_wgmmaILi256"
          "EEEvNS_6DqArgsE")
    k3 = ("_ZN45_GLOBAL__N__eed8c072_12_flash_bwd_cu_3c15cd2811dkv_onepassILi"
          "256EEEvNS_7DkvArgsE")
    text = "\n".join([
        "ptxas info    : (C7512) Potential Performance Loss: wgmma.mma_async "
        "instructions are serialized due to insufficient register resources "
        f"for the function '{k2}'",
        f"ptxas info    : Compiling entry function '{k3}' for 'sm_90a'",
        "ptxas info    : Function properties for x",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 219 registers, used 2 barriers",
        f"ptxas info    : Compiling entry function '{k2}' for 'sm_90a'",
        "    136 bytes stack frame, 140 bytes spill stores, 136 bytes spill "
        "loads",
        "ptxas info    : Used 168 registers, used 1 barriers, 136 bytes "
        "cumulative stack size"])
    got = chip_smoke.ptxas_summary(text)
    assert got[k3] == {"registers": 219, "spill_stores": 0, "notes": []}
    assert got[k2] == {"registers": 168, "spill_stores": 140,
                       "notes": ["C7512"]}
    assert chip_smoke._template_name(k3, 256) == "dkv_onepass"
    assert chip_smoke._template_name(k2, 256) == "dq_wgmma"
    assert chip_smoke._template_name(k2, 128) is None
    # phase 2 names K1's d 192 kernels too
    k1 = ("_ZN45_GLOBAL__N__3a8e5b1c_12_flash_fwd_cu_7f1d2e0915flash_fwd_rows8"
          "ILi192EEEvNS_7FwdArgsE")
    assert chip_smoke._template_name(k1, 192) == "flash_fwd_rows8"
    assert chip_smoke._template_name(k1, 256) is None


def test_sdpa_backend_names_a_backend():
    """The yardstick's backend label: the first SDPA backend that takes the
    inputs (on the CPU too, where the helper runs the same way)."""
    import torch
    from torch.nn.attention import SDPBackend

    q, k, v = (torch.randn(1, heads, 64, 64) for heads in (4, 2, 2))
    assert chip_smoke._sdpa_backend(q, k, v) in SDPBackend.__members__


def test_policy_settings():
    """Phase 13 trains at the CLI's defaults (steps, batch 64), resumes
    mid-run, fills every pool slot the model has, offers demands both one
    host and several take, and keeps its files under the gitignored
    build/."""
    import inspect

    from service_account_auth_improvements_tpu_torch.controlplane.scheduler.policy import (  # noqa: E501
        features,
        train as ptrain,
    )

    defaults = inspect.signature(ptrain.fit_policy).parameters
    assert chip_smoke.POLICY_STEPS == defaults["steps"].default == 300
    assert chip_smoke.POLICY_BATCHES[0] == defaults["batch_size"].default
    assert chip_smoke.POLICY_BATCHES == (64, 4096)
    assert 0 < chip_smoke.POLICY_RESUME_AT < chip_smoke.POLICY_STEPS
    assert len(chip_smoke.POLICY_POOLS) == features.MAX_POOLS
    assert len({h * c for h, c in chip_smoke.POLICY_POOLS}) > 3
    assert {h > 1 for _, h in chip_smoke.POLICY_DEMANDS} == {True, False}
    assert chip_smoke.POLICY_ROWS == 16_384
    assert chip_smoke.POLICY_WARMUP >= 1 and chip_smoke.POLICY_TIMED >= 10
    assert chip_smoke.POLICY_DIR.parent == ROOT / "build"
    assert chip_smoke.POLICY_TOL["loss"] <= 1e-5


class _Event:
    """``torch.cuda.Event`` on the host clock, for the CPU rehearsal."""

    def __init__(self, **_):
        self.t = None

    def record(self):
        import time

        self.t = time.perf_counter()

    def elapsed_time(self, end):
        return (end.t - self.t) * 1e3


def test_policy_phase_rehearses_on_the_cpu(monkeypatch, capsys):
    """Phase 13 end to end on the CPU at a small journal: the journal
    featurizes with nothing dropped, the CLI trains at both batches, the
    checks hold (the CPU run against itself), the resume is bit-equal,
    the checkpoint layout is the reference's, ``choose_index`` names
    feasible pools only, and torchrun starts the training CLI over gloo
    from ``gpu.worker_env``'s env."""
    import torch

    # one thread here and in the torchrun launch: the tensors are tiny,
    # and with the suite's workers sharing the cores more threads contend
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    monkeypatch.setattr(chip_smoke, "DEV", "cpu")
    monkeypatch.setattr(chip_smoke, "POLICY_ROWS", 512)
    monkeypatch.setattr(chip_smoke, "POLICY_BATCHES", (64, 256))
    monkeypatch.setattr(torch.cuda, "Event", _Event)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    try:
        timings = chip_smoke.phase_policy()
    finally:
        torch.set_num_threads(threads)
    out = capsys.readouterr().out
    assert sorted(timings) == [64, 256]
    assert all(t["step_ms"] > 0 for t in timings.values())
    assert "bit-equal to the straight run" in out
    assert "23 arrays (4 header, 6 params, 13 optimizer leaves)" in out
    assert "named a feasible pool every time" in out
    assert "process group gloo: rank 0 of 1 on cpu" in out
    assert not chip_smoke.POLICY_DIR.exists()


def test_policy_journal_is_the_reconcilers_shape():
    """Every row passes the port's ``check_row``, names its best-fit pool
    among the feasible ones, and the feasible lists are the rule's."""
    from service_account_auth_improvements_tpu_torch.controlplane.scheduler.policy import (  # noqa: E501
        features,
    )

    rows = chip_smoke.policy_journal(400, seed=3)
    assert rows == chip_smoke.policy_journal(400, seed=3)
    shapes = {f"pool-{i:02d}": s
              for i, s in enumerate(chip_smoke.POLICY_POOLS)}
    multi = 0
    for row in rows:
        a = row["attrs"]
        assert features.check_row(a) == []
        assert a["pool"] in a["feasible"]
        leftover = {p: a["free_chips"][p] - a["demand_chips"]
                    for p in a["feasible"]}
        assert a["pool"] == min(a["feasible"],
                                key=lambda p: (leftover[p], p))
        for p, (hosts, chips) in shapes.items():
            if a["demand_hosts"] > 1:
                fits = (hosts >= a["demand_hosts"]
                        and a["free_chips"][p] == hosts * chips)
            else:
                fits = (chips >= a["demand_chips"]
                        and a["free_chips"][p] >= a["demand_chips"])
            assert fits == (p in a["feasible"]), (p, a)
        multi += a["demand_hosts"] > 1
    assert 0 < multi < len(rows)
    assert features.dataset(rows)["dropped"] == 0


def _kernel_body(source, kernel):
    """The text of ``__global__`` kernel ``kernel`` in ``source``, from its
    signature to its closing brace."""
    start = re.search(rf"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)"
                      rf"\s+)?{kernel}\(", source).start()
    return source[start:source.index("\n}\n", start)]


def _helper_body(text, name):
    """The text of PairExchange's member ``name`` in hopper.cuh, from its
    signature to its closing brace."""
    start = re.search(rf"\b{name}\([^;{{]*\)[^;{{]*\{{", text).start()
    return text[start:text.index("\n  }\n", start)]


@pytest.mark.parametrize("kernel,source", [
    ("flash_fwd_pair", "flash_fwd"), ("dq_pair", "flash_bwd"),
    ("dkv_pair", "flash_bwd")])
def test_pairs_release_their_receive_buffers_one_way(kernel, source):
    """Every pair of blocks hands its receive buffers back to the peer
    through hopper.cuh's one exchange helper (PairExchange): the one
    remote arrival (released at CTA scope, the helper's comment says why)
    is made only in PairExchange::release, by one thread right past a
    named barrier of the buffers' readers; no pair kernel stores into the
    peer, waits on or arrives at its barriers, or crosses the cluster
    barrier itself; and the buffers are read only by the helper's loads
    into registers (the kernel names their offset only to build it)."""
    hopper = (CSRC / "hopper.cuh").read_text()
    remote = re.findall(r"mbarrier\.arrive[.\w]*\.shared::cluster", hopper)
    assert remote == ["mbarrier.arrive.release.cta.shared::cluster"]
    helper = hopper[hopper.index("struct PairExchange {"):]
    helper = helper[:helper.index("\n};\n")]
    release = _helper_body(helper, "release")
    assert re.search(r"bar_sync\([^)]*READERS\);\n\s+if \(threadIdx\.x % "
                     r"READERS == 0\) mbar_arrive_remote_cta\(freed_peer\);",
                     release)
    # the arrival, stated once with the rule it rests on, and nowhere else
    assert hopper.count("mbar_arrive_remote_cta(") == 2  # definition, call
    assert release.count("mbar_arrive_remote_cta(") == 1
    head = helper[:helper.index("void release(")].splitlines()[:-1]
    comment = []
    while head and head[-1].lstrip().startswith("//"):
        comment.insert(0, head.pop().lstrip("/ "))
    comment = " ".join(comment)
    for rule in ("CTA scope", "load into a register", "named barrier",
                 "no receive buffer feeds a wgmma"):
        assert rule in comment, rule
    sources = "".join(f.read_text() for f in sorted(CSRC.glob("*.c*")))
    assert sources.count("no receive buffer feeds a wgmma") == 1
    assert sources.count("bar.sync returns once") == 1
    # the receive buffers' reads: loads into registers in recv_add and
    # unstash alone
    reads = [m for m in ("recv_add", "unstash")
             if re.search(r"(in|buf)\)?\[", _helper_body(helper, m))]
    assert reads == ["recv_add", "unstash"]
    body = _kernel_body((CSRC / f"{source}.cu").read_text(), kernel)
    for call in ("st_async_16(", "mbar_wait_cluster(",
                 "mbar_arrive_remote_cta(", "cluster_arrive(", "cluster_wait(",
                 "cluster_map("):
        assert call not in body, call
    for call in ("L::X::init(", "L::X::begin();", ".send(", ".recv_add(",
                 ".release(", "L::X::end("):
        assert call in body, call
    assert body.count("L::X_OFF") == 2  # the helper's two views of them


@pytest.mark.parametrize("kernel", ["dq_wide_f32", "dkv_wide_f32",
                                    "flash_fwd_wide_f32", "dkv_wide"])
def test_cluster_sum_adds_in_rank_order_and_reads_into_registers(kernel):
    """The f32 K1, K2 and K3 and the bf16 K3 on a cluster exchange their
    partial scores through hopper.cuh's ClusterSum alone: its gather adds
    the n partials of an owned unit in rank order, rank 0's first, the
    owner's own from its registers, and sends the sum on; its receive
    buffers are read only by loads into registers, `rs` in gather and `ag`
    in collect (every slot, the owned units' selected away, with no branch
    around a register write), and handed back by no arrival of their own
    (the comment states the rule that makes that sound); the kernel stores
    into no peer and waits on no remote barrier itself. The f32 kernels run
    the last tile's product (K1: P V, ``pv``) between scatter and gather
    and between gather and collect; the bf16 K3 runs two instances (stage
    m on m & 1): it issues the next stage's scores and the last stage's
    product, waits for both (refilling that stage), scatters the next
    stage's partials, then gathers and collects this stage's sums."""
    hopper = (CSRC / "hopper.cuh").read_text()
    helper = hopper[hopper.index("struct ClusterSum {"):]
    helper = helper[:helper.index("\n};\n") + 1]
    gather = _helper_body(helper, "gather")
    order = [gather.index(s) for s in (
        "mbar_wait_cluster(bar, phase);",
        "float4 s = rank == 0 ? own : rs[u - lo];",
        "for (int src = 1; src < NMAX; ++src) {",
        "src == rank ? own",
        "s.x += v.x;",
        "st_async_16(cluster_map(ag_addr + u * 16, p), s.x, s.y, s.z, s.w,")]
    assert order == sorted(order)
    reads = {m: re.findall(r"\b(rs|ag)\[", _helper_body(helper, m))
             for m in ("scatter", "gather", "collect")}
    assert reads == {"scatter": [], "gather": ["rs", "rs"],
                     "collect": ["ag"]}
    collect = _helper_body(helper, "collect")
    assert "continue" not in collect and "if (own" not in collect
    assert "r[4 * k] = own ? r[4 * k] : v.x;" in collect
    assert "mbar_arrive_remote_cta" not in helper
    head = hopper[:hopper.index("struct ClusterSum {")]
    head = head[head.rindex("// ---"):]
    comment = " ".join(line.lstrip("/ ") for line in head.splitlines())
    for rule in ("load into a register", "before its next store into a peer",
                 "rank order", "no read is outstanding"):
        assert rule in comment, rule
    body = _kernel_body((CSRC / f"{chip_smoke.WIDE_SOURCE}.cu").read_text(),
                        kernel)
    for call in ("st_async_16(", "mbar_wait_cluster(",
                 "mbar_arrive_remote_cta(", "cluster_arrive(", "cluster_wait(",
                 "cluster_map("):
        assert call not in body, call
    if kernel == "dkv_wide":
        # two instances, stage m on m & 1: stage n + 1's partials go out
        # before stage n's sums are gathered
        assert body.count(".scatter(") == 2
        assert body.count(".gather(") == body.count(".collect(") == 1
        steps = [body.index(s) for s in (
            "L::X::init(xbar, a.groups, rank);",
            "L::X::init(xbar + 8 * L::X::BARS, a.groups, rank);",
            "L::X::begin();", "xc(0).scatter(st);",
            "scores(sn, next ? n + 1 : n);", "product(n > 0 ? n - 1 : 0);",
            "wgmma_wait<0>();  // the scores and the last stage's product",
            "bar_sync(2, THREADS);", "if (next) xc(n + 1).scatter(sn);",
            "x_n.gather(st, (n >> 1) & 1, n + 2 < tiles);",
            "x_n.collect(st, (n >> 1) & 1, n + 2 < tiles);",
            "bar_sync(1, THREADS);", "L::X::end(")]
        assert steps == sorted(steps)
        assert "(m & 1) * L::X::BYTES" in body
        return
    assert body.count("xc.scatter(") == body.count("xc.gather(") == 1
    product = "pv(" if kernel == "flash_fwd_wide_f32" else "product("
    steps = [body.index(s) for s in (
        "L::X::init(", "L::X::begin();", "xc.scatter(r);", product,
        "xc.gather(r,", product, "xc.collect(r,", "L::X::end(")]
    assert steps[3] < steps[4] < body.index(product, steps[4]) < steps[6]
    assert steps[:3] == sorted(steps[:3]) and steps[6] < steps[7]


@pytest.mark.parametrize("variant,d", [
    (None, 512), (None, 384), ("dq_pair_bk64_one_stage", 512),
    ("dq_pair_d384_bk64", 384)])
def test_dq_pair_tiles_fit_and_exchange_in_whole_rounds(variant, d):
    """dq_pair's key tiles at d 384 and 512, as committed and as the
    variants time them (one 64-key stage at d 512, two at d 384): whole
    rounds of XK keys a tile, and Q, dO, the K/V stages, the receive
    buffers and the mbarriers within SMEM_MAX."""
    files = kernel_variants.committed_files("flash_bwd")
    if variant is not None:
        files = kernel_variants.variant_files(variant, files)
    source = files["flash_bwd.cu"]
    struct = source[source.index("struct DqPair {"):]
    struct = struct[:struct.index("\n};\n")]
    const = {name: _constexpr(re.search(rf"int {name} = ([^;]*);",
                                        struct).group(1), d)
             for name in ("BQ", "BK", "STAGES", "XK")}
    smem_max = int(re.search(r"SMEM_MAX = (\d+);", source).group(1))
    dh, wg = d // 2, 128
    assert const["BK"] % const["XK"] == 0 and const["STAGES"] >= 1
    smem = (2 * const["BQ"] * dh * 2 + 2 * const["STAGES"] * const["BK"]
            * dh * 2 + 2 * (const["XK"] // 4) * 16 * wg
            + 8 * (1 + 2 * const["STAGES"] + 4) + 1024)
    assert smem <= smem_max
    # one stage more does not fit
    assert smem + 2 * const["BK"] * dh * 2 > smem_max or const["STAGES"] == 4
    if variant == "dq_pair_bk64_one_stage":
        assert (const["BK"], const["STAGES"]) == (64, 1)
    if variant == "dq_pair_d384_bk64":
        assert (const["BK"], const["STAGES"]) == (64, 2)


@pytest.mark.parametrize("d", [384, 512])
def test_fwd_pair_tiles_fit(d):
    """flash_fwd_pair at d 384 and 512: Q (128 rows at D / 2), the K and V
    stages of BK keys, the two receive buffers (BK / 2 partial scores a
    thread) and the mbarriers within SMEM_MAX; at d 512 two stages, a
    third does not fit (at d 384 three)."""
    source = (CSRC / "flash_fwd.cu").read_text()
    struct = source[source.index("struct FwdPair {"):]
    struct = struct[:struct.index("\n};\n")]
    bk, stages = (_constexpr(re.search(rf"int {name} = ([^;]*);",
                                       struct).group(1), d)
                  for name in ("BK", "STAGES"))
    smem_max = int(re.search(r"SMEM_MAX = (\d+);", source).group(1))
    dh, wg = d // 2, 128
    def smem(n):
        return (128 * dh * 2 + 2 * n * bk * dh * 2 + 2 * (bk // 8) * 16 * wg
                + 8 * (1 + 3 * n + 4) + 1024)
    assert smem(stages) <= smem_max < smem(stages + 1)
    assert stages == {384: 3, 512: 2}[d]
    assert "static_assert(DH % 64 == 0 && DH <= 256" in struct


wide_steps = _script("wide_steps")


@pytest.mark.parametrize("name", sorted(chip_smoke.WIDE_HEADS))
def test_wide_steps_takes_each_wide_configuration(name):
    """wide_steps.py runs phase 12 for the configurations named, in that
    order, and all of them, in WIDE_HEADS's order, if none is named."""
    args = wide_steps.parse_args(["--profile", name, name])
    assert args.names == [name] and args.profile == name
    assert not args.other_k1 and not args.other_wide and not args.watch
    assert args.steps == chip_smoke.WIDE_STEPS
    assert wide_steps.parse_args([]).names == list(chip_smoke.WIDE_HEADS)


@pytest.mark.parametrize("argv", [["bench_800m_d1024"], ["--steps", "1"]])
def test_wide_steps_refuses_what_phase_12_cannot_run(argv):
    """An unknown configuration, or fewer steps than a warm-up and one
    timed step."""
    with pytest.raises(SystemExit):
        wide_steps.parse_args(argv)


def test_wide_steps_watcher_logs_a_stay_and_a_collection(monkeypatch):
    """--watch's watcher logs where the main thread stayed longer than
    WATCH_S and each garbage collection longer than WATCH_GC_S."""
    import gc
    import time

    lines = []
    monkeypatch.setattr(wide_steps.cs, "_log", lines.append)
    monkeypatch.setattr(wide_steps, "WATCH_GC_S", 0.0)
    with wide_steps._watched("check"):
        time.sleep(3 * wide_steps.WATCH_S)
        gc.collect()
    assert any("seen at one place" in line and "time.sleep" not in line
               and "test_torch_chip_smoke.py" in line for line in lines)
    assert any("garbage collection of generation 2" in line
               for line in lines)


def test_wide_steps_needs_a_card(monkeypatch):
    """Without a CUDA card wide_steps.py exits non-zero before any
    phase runs."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr("sys.argv", ["wide_steps.py", "--other-k1"])
    assert wide_steps.main() == 1


def test_wide_steps_other_wide_runs_the_other_streamed_build(monkeypatch):
    """--other-wide builds csrc/flash_wide.cu with the other designs and
    runs phase 12 with that library in the streamed source's place (the
    per-dim ones as shipped, and K1's unless --other-k1)."""
    import torch

    from service_account_auth_improvements_tpu_torch.ops import _build

    built, loaded, ran = [], [], []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(wide_steps.cs, "phase_device", lambda: None)
    monkeypatch.setattr(wide_steps.cs, "_log", lambda msg: None)
    monkeypatch.setattr(wide_steps.cs, "_build_other_designs",
                        lambda name: built.append(name) or ROOT / f"lib{name}")
    monkeypatch.setattr(_build, "load", loaded.append)
    monkeypatch.setattr(wide_steps.ctypes, "CDLL", lambda path: ("other", path))
    monkeypatch.setattr(wide_steps.cs, "_timed",
                        lambda label, fn, window: ran.append(label))
    # main narrows both; the test puts them back
    monkeypatch.setattr(wide_steps.cs, "WIDE_HEADS",
                        dict(chip_smoke.WIDE_HEADS))
    monkeypatch.setattr(wide_steps.cs, "WIDE_STEPS", chip_smoke.WIDE_STEPS)
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr("sys.argv", ["wide_steps.py", "--other-wide",
                                     "--steps", "16", "bench_800m_d768"])
    assert wide_steps.main() == 0
    assert built == [chip_smoke.WIDE_SOURCE]
    assert _build._libs == {chip_smoke.WIDE_SOURCE: (
        "other", str(ROOT / f"lib{chip_smoke.WIDE_SOURCE}"))}
    assert loaded == list(chip_smoke.KERNEL_SOURCES)
    assert ran == ["wide heads"]
    assert wide_steps.cs.WIDE_HEADS == {
        "bench_800m_d768": chip_smoke.WIDE_HEADS["bench_800m_d768"]}
    assert wide_steps.cs.WIDE_STEPS == 16
