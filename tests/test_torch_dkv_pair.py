"""K3's pair of blocks (``dkv_pair``) at head dims 320 and 448, emulated on
the CPU.

On the card ``dkv_pair<D>`` gives each block of a cluster of two DH = 64
ceil(D / 128) head-dim columns: rank 0 holds columns [0, DH) and rank 1
[DH, D), its tile padded to DH columns with TMA's zeros (at d 320 and 448,
where D / 2 is no whole number of 64-column blocks). Each block forms the
partial S^T = K Qᵀ and dP^T = V dOᵀ over its own columns, the pair sums the
two partials, and each block accumulates dV = Pᵀ dO and dK = dSᵀ Q over its
own columns and stores only its real ones. ``_pair_dkv`` is that
arithmetic in plain PyTorch, held against ``flash_bwd_dkv_reference`` in
f32 and against the JAX package's ``_flash_bwd`` (interpret mode, as its
own tests run it on the CPU) in bf16. The kernel itself runs only on the
card (tests/test_torch_cuda.py, chip_smoke.py).
"""

from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from service_account_auth_improvements_tpu.ops import (  # noqa: E402
    flash_attention as jfa,
)
from service_account_auth_improvements_tpu_torch.ops import (  # noqa: E402
    flash_attention as tfa,
)

CSRC = (Path(__file__).resolve().parent.parent
        / "service_account_auth_improvements_tpu_torch" / "csrc")


def _columns(d):
    """DH, the head-dim columns each block of the pair holds at head dim d:
    64 ceil(d / 128), as csrc/flash_bwd.cu's DkvPair states it."""
    dh = 64 * -(-d // 128)
    source = (CSRC / "flash_bwd.cu").read_text()
    struct = source[source.index("struct DkvPair {"):]
    assert "static constexpr int DH = 64 * ((D + 127) / 128);" in struct
    return dh


def _pair_dkv(q, k, v, do, lse, delta, causal):
    """dkv_pair's arithmetic on [b, heads, s, d] tensors → (dk, dv) in k's
    and v's dtypes: the two blocks' zero-padded column tiles, their
    partial scores summed (rank 0's first), P rounded to dO's dtype and dS
    to q's as the kernel does, dK scaled once, the padded columns dropped."""
    b, h, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    dh, g = _columns(d), h // hkv

    def tiles(t):
        padded = torch.nn.functional.pad(t.float(), (0, 2 * dh - d))
        return padded[..., :dh], padded[..., dh:]

    qs, ks, vs, dos = (tiles(t) for t in (q, k, v, do))
    grouped = [(qs[r].reshape(b, hkv, g, sq, dh),
                dos[r].reshape(b, hkv, g, sq, dh)) for r in range(2)]
    st = dpt = 0.0
    for r in range(2):
        qg, dog = grouped[r]
        st = st + torch.einsum("bhgqd,bhkd->bhgqk", qg, ks[r])
        dpt = dpt + torch.einsum("bhgqd,bhkd->bhgqk", dog, vs[r])
    s = st * d ** -0.5
    p = torch.exp(s - lse.reshape(b, hkv, g, sq, 1))
    if causal:
        rows = torch.arange(sq)[:, None]
        cols = torch.arange(sk)[None, :]
        p = p.masked_fill(rows < cols, 0.0)
    p = p.to(do.dtype).float()
    ds = (p * (dpt - delta.reshape(b, hkv, g, sq, 1))).to(q.dtype).float()
    dk, dv = [], []
    for r in range(2):
        qg, dog = grouped[r]
        dv.append(torch.einsum("bhgqk,bhgqd->bhkd", p, dog))
        dk.append(torch.einsum("bhgqk,bhgqd->bhkd", ds, qg) * d ** -0.5)
    dk, dv = torch.cat(dk, -1), torch.cat(dv, -1)
    # the columns past d come from zero operands: exactly zero, not stored
    assert not dk[..., d:].any() and not dv[..., d:].any()
    return dk[..., :d].to(k.dtype), dv[..., :d].to(v.dtype)


def _inputs(b, s, h, hkv, d, seed, dtype=torch.float32):
    rng = np.random.default_rng(seed)
    q, k, v, do = (torch.tensor(rng.standard_normal((b, heads, s, d)),
                                dtype=torch.float32).to(dtype)
                   for heads in (h, hkv, hkv, h))
    return q, k, v, do


@pytest.mark.parametrize("d", [320, 384, 448, 512])
def test_pair_columns_tile_the_head_dim(d):
    """Rank 0's DH columns and rank 1's d - DH real ones are [0, d), once
    each; rank 1 pads 64 columns at d 320 and 448 and none at 384, 512."""
    dh = _columns(d)
    assert dh % 64 == 0 and 0 < d - dh <= dh
    assert 2 * dh - d == (64 if d in (320, 448) else 0)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [320, 384, 448, 512])
def test_pair_emulation_matches_the_plain_version_f32(d, causal):
    """In f32 the padded split is the plain K3 within 1e-5: the zero
    columns add nothing, only the order of the sums differs. GQA group 2,
    a ragged length."""
    q, k, v, do = _inputs(1, 200, 4, 2, d, seed=d)
    o, lse = tfa.flash_fwd_reference(q, k, v, causal)
    delta = tfa.flash_bwd_delta(o, do)
    got = _pair_dkv(q, k, v, do, lse, delta, causal)
    want = tfa.flash_bwd_dkv_reference(q, k, v, do, lse, delta, causal)
    for g, w, n in zip(got, want, "kv"):
        assert g.shape == w.shape and g.dtype == torch.float32
        torch.testing.assert_close(g, w, atol=1e-5, rtol=1e-5,
                                   msg=lambda m: f"d{n}: {m}")


@pytest.mark.parametrize("d", [320, 448])
def test_pair_emulation_bf16_matches_jax_flash_bwd(d, monkeypatch):
    """In bf16 the padded split, fed the JAX forward's O and LSE, is the
    JAX package's ``_flash_bwd`` (interpret mode, blocks of 128, two per
    axis, GQA group 2) within the bf16 backward tolerance of
    tests/test_torch_flash.py's bf16 case (atol 6e-2, rtol 2e-2)."""
    monkeypatch.setattr(jfa, "_pick_block", lambda seq, want: 128)
    q, k, v, do = _inputs(1, 256, 4, 2, d, seed=d + 1, dtype=torch.bfloat16)
    jq, jk, jv, jdo = (jnp.asarray(t.float().numpy(), jnp.bfloat16)
                       for t in (q, k, v, do))
    jo, jlse = jfa._flash_fwd(jq, jk, jv, causal=True, interpret=True)
    _, want_dk, want_dv = jfa._flash_bwd(jq, jk, jv, jo, jlse, jdo,
                                         causal=True, interpret=True)
    o = torch.tensor(np.asarray(jo, np.float32)).bfloat16()
    # the JAX forward stores each row's LSE lane-replicated
    lse = torch.tensor(np.asarray(jlse, np.float32)[..., 0])
    delta = tfa.flash_bwd_delta(o, do)
    got = _pair_dkv(q, k, v, do, lse, delta, True)
    for g, w, n in zip(got, (want_dk, want_dv), "kv"):
        assert g.dtype == torch.bfloat16 and tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.float().numpy(),
                                   np.asarray(w, np.float32), atol=6e-2,
                                   rtol=2e-2, err_msg=f"d{n}")
