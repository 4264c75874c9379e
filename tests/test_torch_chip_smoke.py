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
    dims every kernel is built for, differ from the preset only in their
    heads, and time steps after a warm-up."""
    import dataclasses

    from service_account_auth_improvements_tpu_torch.models import llama
    from service_account_auth_improvements_tpu_torch.ops import (
        flash_attention as fa,
    )

    base = llama.PRESETS[chip_smoke.PRESET]
    assert sorted(d for _, _, d in chip_smoke.WIDE_HEADS.values()) == [
        192, 256, 384, 512]
    for name, (h, hkv, d) in chip_smoke.WIDE_HEADS.items():
        assert name == f"{chip_smoke.PRESET}_d{d}"
        assert d in fa.KERNEL_HEAD_DIMS and h % hkv == 0
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
    assert chip_smoke.WIDE_HEADS["bench_800m_d512"] == (3, 1, 512)
    assert chip_smoke.WIDE_HEADS["bench_800m_d384"] == (4, 2, 384)
    assert set(chip_smoke.WIDE_SERVED) == {256, 512}
    assert set(chip_smoke.WIDE_VS_DENSE) == {384, 512}
    assert chip_smoke.WIDE_STEPS >= 2


def test_kernel_only_head_settings():
    """Phase 3 checks and times K1, K2 and K3 at every head dim the split
    kernels take (d 320 and 448 with no model, 4 / 2 heads), and at d 256
    under both designs; the d 512 kernels line carries the kernel-only
    dims; the profile groups name the split kernels, and the d 192 and 256
    design labels come from K1's, K2's and K3's design functions."""
    from service_account_auth_improvements_tpu_torch.ops import (
        flash_attention as fa,
    )

    assert chip_smoke.KERNEL_ONLY_HEADS == {"d320": (4, 2, 320),
                                            "d448": (4, 2, 448)}
    dims = sorted(d for _, _, d in chip_smoke._kernel_heads().values())
    assert dims == [192, 256, 320, 384, 448, 512]
    assert set(dims) <= set(fa.KERNEL_HEAD_DIMS)
    assert fa.KERNEL_HEAD_DIMS[-1] == 512
    for kernel in ("flash_fwd_split", "dq_split", "dkv_split"):
        assert kernel in chip_smoke.PROFILE_KERNELS
    src = {name: (CSRC / f"{name}.cu").read_text()
           for name in chip_smoke.KERNEL_SOURCES}
    for name, fn in (("flash_fwd", "flash_fwd_design(int d)"),
                     ("flash_bwd", "flash_bwd_dq_design(int d)"),
                     ("flash_bwd", "flash_bwd_dkv_design(int d)")):
        assert f'extern "C" int {fn}' in src[name]
    for text in src.values():
        assert "#ifndef FLASH_OTHER_DESIGNS" in text
    assert chip_smoke.DESIGN_DIMS == (64, 192, 256)


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
    it: the twin blocks at d 64, the rows on 8 warps at d 256, the row
    split at d 128 and 192 (the other build: the row split at d 64 and
    256, the rows on 8 warps at d 192), the D split above."""

    def __init__(self, other):
        ids = _designs("flash_fwd", "FwdDesign")
        two = {64: ("kTwin", "kRowSplit"), 192: ("kRowSplit", "kRows8"),
               256: ("kRows8", "kRowSplit")}
        self.flash_fwd_design = lambda d: ids[
            "kRowSplit" if d == 128 else "kDSplit" if d > 256
            else two[d][1 if other else 0]]


def test_fwd_design_labels_name_every_design():
    """chip_smoke.py labels each id K1's design function can return, and
    no other, with the names K2's and K3's ids of the same design carry
    (the twin blocks, K1's alone, take an id no K2 or K3 design has); the
    source's rule: the twin blocks at d 64, the rows on 8 warps at d 256,
    the row split at d 128 and 192 (a -DFLASH_OTHER_DESIGNS=1 build takes
    the row split at d 64 and 256 and the rows on 8 warps at d 192), the
    D split from d 320."""
    ids = _designs("flash_fwd", "FwdDesign")
    assert ids == {"kRowSplit": 0, "kDSplit": 1, "kRows8": 2, "kTwin": 5}
    assert set(chip_smoke.FWD_DESIGNS) == set(ids.values())
    assert ids["kTwin"] not in chip_smoke.BWD_DESIGNS
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
        ": kDSplit;")
    assert 'extern "C" int flash_fwd_design(int d) { return fwd_design(d); }' \
        in text
    for d, shipped, other in ((64, "twin blocks of 8 warps", "row split"),
                              (128, "row split", "row split"),
                              (192, "row split", "rows on 8 warps"),
                              (256, "rows on 8 warps", "row split"),
                              (320, "D split", "D split"),
                              (512, "D split", "D split")):
        assert chip_smoke.FWD_DESIGNS[_Fwd(False).flash_fwd_design(d)] == (
            shipped)
        assert chip_smoke.FWD_DESIGNS[_Fwd(True).flash_fwd_design(d)] == (
            other)


class _Bwd:
    """A flash_bwd library's design functions, as csrc/flash_bwd.cu states
    them: K2's dq_rows8 at d 64, 192 and 256, K3's 8-warp designs at d 64
    (dkv_keys8) and 256 (dkv_onepass), the row split at d 128 (and K3's
    at d 192), the D split above (the row split at d 64, 192 and 256 and
    K3's one pass at d 192 in the other build)."""

    def __init__(self, other):
        ids = _bwd_designs()
        row8, one, keys8 = ((ids["kRowSplit"],) * 3 if other
                            else (ids["kRows8"], ids["kOnePass"],
                                  ids["kKeys8"]))
        self.flash_bwd_dq_design = lambda d: (
            row8 if d in (64, 192, 256) else ids["kRowSplit"] if d <= 128
            else ids["kDSplit"])
        self.flash_bwd_dkv_design = lambda d: (
            keys8 if d == 64 else ids["kRowSplit"] if d <= 128
            else one if d == 256
            else ids["kOnePass" if other else "kRowSplit"] if d == 192
            else ids["kDSplit"])


def test_bwd_design_labels_name_every_design():
    """chip_smoke.py labels each id K2's and K3's design functions can
    return, and no other; ``design_names`` reads K1's, K2's and K3's ids:
    at d 64 and 256 the 8-warp designs ship, at d 192 K2's, and a build
    with -DFLASH_OTHER_DESIGNS=1 runs the 12-warp row split there (and
    K1's rows on 8 warps and K3's one pass at d 192, where their row
    split ships)."""
    ids = _bwd_designs()
    assert ids == {"kRowSplit": 0, "kDSplit": 1, "kRows8": 2, "kOnePass": 3,
                   "kKeys8": 4}
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
    assert chip_smoke.design_names(_Fwd(False), _Bwd(False), 512) == {
        "flash_fwd": "D split", "flash_bwd_dq": "D split",
        "flash_bwd_dkv": "D split"}
    # the design functions follow the same rule in the source
    text = (CSRC / "flash_bwd.cu").read_text()
    rule = re.search(r"constexpr int dq_design\(int d\) \{(.*?)\}", text,
                     re.S).group(1)
    assert " ".join(rule.split()) == (
        "return d == 64 || d == 192 || d == 256 ? (FLASH_OTHER_DESIGNS ? "
        "kRowSplit : kRows8) : d <= 128 ? kRowSplit : kDSplit;")
    rule = re.search(r"constexpr int dkv_design\(int d\) \{(.*?)\}", text,
                     re.S).group(1)
    assert " ".join(rule.split()) == (
        "return d == 64 ? (FLASH_OTHER_DESIGNS ? kRowSplit : kKeys8) : d <= "
        "128 ? kRowSplit : d == 192 ? (FLASH_OTHER_DESIGNS ? kOnePass : "
        "kRowSplit) : d == 256 ? (FLASH_OTHER_DESIGNS ? kRowSplit : "
        "kOnePass) : kDSplit;")


def test_design_kernels_name_the_shipped_and_other_kernels():
    """``design_kernels`` names the kernel template each design id runs
    (DESIGN_KERNELS, every one a kernel of csrc/): at d 64 K1, K2 and K3
    ship flash_fwd_twin, dq_rows8 and dkv_keys8, the other build runs
    flash_fwd_wgmma, dq_wgmma and dkv_wgmma there; at d 192 K2 ships
    dq_rows8, the other build runs dq_wgmma."""
    fwd_ids = _designs("flash_fwd", "FwdDesign")
    bwd_ids = _bwd_designs()
    kernels = chip_smoke.DESIGN_KERNELS
    assert set(kernels["flash_fwd"]) == set(fwd_ids.values())
    assert set(kernels["flash_bwd_dq"]) | set(kernels["flash_bwd_dkv"]) == (
        set(bwd_ids.values()))
    for table in kernels.values():
        assert set(table.values()) <= _global_kernels()
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
    for d in (192, 256):
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


def test_wide_entries_carry_designs_and_pair():
    """The wide head dims' ``kernels`` entries: every key the line's
    contract names, launches summed over phase 12's paths; at d 192 and
    256 (all three kernels, K2 at d 192 too now that it has two designs
    there) the designs timed in turns, and K2's and K3's the pair's sum
    beside SDPA's backward; the kernel-only dims under d 512."""
    keys = ("shape", "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "library_backend", "tflops", "bound_share")
    labels = {**chip_smoke.WIDE_HEADS, **chip_smoke.KERNEL_ONLY_HEADS}
    numbers = {}
    for name in chip_smoke.KERNELS:
        numbers[name] = {"wide": {}}
        for i, label in enumerate(labels):
            n = {key: float(i + 1) for key in keys}
            if name != "flash_fwd":
                n["pair_ms"] = 2.0 * (i + 1)
            numbers[name]["wide"][label] = n
    wide = {d: {"training": {name: 20 for name in chip_smoke.KERNELS},
                "serving": {name: 0 for name in chip_smoke.KERNELS}}
            for _, _, d in chip_smoke.WIDE_HEADS.values()}
    designs = {d: {name: {"shipped_ms": 1.0, "other_ms": 2.0}
                   for name in chip_smoke.KERNELS}
               for d in chip_smoke.DESIGN_DIMS}
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
        assert ("designs_in_turns" in entry) == (d in (192, 256))
        assert ("pair_ms" in entry) == (kernel != "flash_fwd")
        assert ("more_shapes" in entry) == (d == 512)
        if "designs_in_turns" in entry:
            assert entry["designs_in_turns"] is designs[d][kernel]
        if d == 512:
            assert set(entry["more_shapes"]) == set(
                chip_smoke.KERNEL_ONLY_HEADS)


def test_f32_design_labels_name_every_design():
    """chip_smoke.py labels each id of K1's, K2's and K3's f32 design
    functions, and no other; each source's rule: the register-tiled
    kernels at every head dim, the scalar ones at d 128 in a
    -DFLASH_OTHER_DESIGNS=1 build (F32_DESIGN_DIM, the dim
    phase_f32_designs times in turns)."""
    assert chip_smoke.F32_DESIGNS == {0: "scalar", 1: "register-tiled"}
    assert chip_smoke.F32_DESIGN_DIM == 128
    for source, fn in (("flash_fwd", "flash_fwd_f32_design"),
                       ("flash_bwd", "flash_bwd_f32_design")):
        ids = _designs(source, "F32Design")
        assert ids == {"kF32Scalar": 0, "kF32Tiled": 1}
        text = (CSRC / f"{source}.cu").read_text()
        rule = re.search(r"constexpr int f32_design\(int d\) \{(.*?)\}",
                         text, re.S).group(1)
        assert " ".join(rule.split()) == (
            "return FLASH_OTHER_DESIGNS && d == 128 ? kF32Scalar : "
            "kF32Tiled;")
        assert (f'extern "C" int {fn}(int d) {{ return f32_design(d); }}'
                in text)

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
