"""Flash attention of the torch port against the JAX reference.

On the CPU ``ops.flash_attention`` runs the plain version (``kernels/ref.py``,
the logits materialised in float32).  It is held against the reference's
Pallas kernel in interpret mode and its jnp oracle on the reference's sweep,
causal and not, with the reference's tolerances: 2e-5 in float32 (the two
forms sum in other orders) and 2e-2 in bfloat16 (one rounding of the output
to 8 bits of mantissa).  Inputs come from numpy with a fixed seed and are
rounded to the dtype the same way (to nearest) in both frameworks.
"""
import math

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.kernels import ops as jops, ref as jref
from repro_torch.kernels import flashattn as tflash
from repro_torch.kernels import ops as tops, ref as tref

# one intra-op thread: the tier-1 run's six pytest-xdist workers would
# otherwise start a thread a core each and oversubscribe the CPU
torch.set_num_threads(1)

TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def _qkv(shape, dtype, seed=0):
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(shape).astype(np.float32) for _ in range(3)]
    jax_in = [jnp.asarray(a).astype(jnp.dtype(dtype)) for a in arrs]
    torch_in = [torch.tensor(a).to(getattr(torch, dtype)) for a in arrs]
    return jax_in, torch_in


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32).numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s,bq,bk", [(16, 8, 8), (32, 8, 16), (64, 64, 32)])
def test_flash_attention_equals_reference(s, bq, bk, dtype, causal):
    (jq, jk, jv), (tq, tk, tv) = _qkv((2, s, 3, 16), dtype, seed=s)
    tops.reset_launch_counts()
    got = tops.flash_attention(tq, tk, tv, causal=causal, bq=bq, bk=bk)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    assert not any(tops.launch_counts().values())     # plain version on CPU
    tol = TOL[dtype]
    for want in (jops.flash_attention(jq, jk, jv, causal=causal, bq=bq,
                                      bk=bk),
                 jref.flash_attention_ref(jq, jk, jv, causal=causal)):
        np.testing.assert_allclose(_f32(got), _f32(want), atol=tol, rtol=tol)
    np.testing.assert_array_equal(
        _f32(got), _f32(tref.flash_attention_ref(tq, tk, tv, causal)))


def test_flash_attention_noncausal_head_dim_8():
    """The reference's non-causal case: D = 8, atol 2e-5, rtol 1e-4."""
    (jq, jk, jv), (tq, tk, tv) = _qkv((1, 32, 2, 8), "float32", seed=3)
    got = tops.flash_attention(tq, tk, tv, causal=False, bq=8, bk=8)
    want = jops.flash_attention(jq, jk, jv, causal=False, bq=8, bk=8)
    np.testing.assert_allclose(_f32(got), _f32(want), atol=2e-5, rtol=1e-4)


def test_flash_attention_caps_blocks_at_s():
    """bq, bk default to 128 and are capped at S = 24 (not a power of 2)."""
    (jq, jk, jv), (tq, tk, tv) = _qkv((1, 24, 2, 16), "float32", seed=4)
    got = tops.flash_attention(tq, tk, tv)
    np.testing.assert_allclose(_f32(got),
                               _f32(jops.flash_attention(jq, jk, jv)),
                               atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("shapes,kw,match", [
    (((1, 24, 2, 16),) * 3, {"bq": 16}, "multiple of the block sizes"),
    (((1, 24, 2, 16),) * 3, {"bk": 7}, "multiple of the block sizes"),
    (((1, 16, 4, 16), (1, 16, 2, 16), (1, 16, 2, 16)), {}, "one"),
    (((1, 16, 2, 16), (1, 16, 2, 16), (1, 8, 2, 16)), {}, "one"),
    (((16, 2, 16),) * 3, {}, "one"),
], ids=["bq", "bk", "gqa-heads", "v-length", "3-d"])
def test_flash_attention_rejects_bad_shapes(shapes, kw, match):
    q, k, v = (torch.zeros(s) for s in shapes)
    with pytest.raises(ValueError, match=match):
        tops.flash_attention(q, k, v, **kw)
    if len(shapes[0]) == 4 and shapes[0] == shapes[1] == shapes[2]:
        with pytest.raises(ValueError, match=match):
            jops.flash_attention(*(jnp.zeros(s) for s in shapes), **kw)


def test_flash_wrapper_rejects_cpu_tensors_before_building():
    q = torch.zeros(1, 16, 2, 16)
    with pytest.raises(ValueError, match="CUDA kernel"):
        tflash.flash_attention(q, q, q)


_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


@pytest.mark.parametrize("d", tflash.HEAD_DIMS)
@pytest.mark.parametrize("dtype", list(_DTYPES))
def test_flash_design_is_a_function_of_dtype_and_head_dim(dtype, d):
    """The tensor cores take the 16-bit types at D >= 64; float32 (TF32
    would miss 2e-5) and the 16-bit D = 8, 16 stay on the FMA pipe."""
    want = ("wgmma" if dtype != "float32" and d in (64, 128, 256)
            else "simt")
    assert tflash.design(_DTYPES[dtype], d) == want


def test_flash_design_rejects_what_no_kernel_takes():
    with pytest.raises(ValueError, match="no flash kernel"):
        tflash.design(torch.float32, 32)
    with pytest.raises(ValueError, match="no flash kernel"):
        tflash.design(torch.float64, 64)


@pytest.mark.parametrize("d,width", [(320, 320), (512, 512), (1000, 1024)])
@pytest.mark.parametrize("dtype", list(_DTYPES))
def test_flash_design_routes_wide_head_dims_to_the_split_kernel(dtype, d,
                                                                width):
    """Past D = 256 every dtype runs the column-split kernel, at D padded
    to a multiple of its 64-column chunk; the kernel takes no other D."""
    assert tflash.padded_head_dim(d) == width
    assert tflash.design(_DTYPES[dtype], width) == "simt_split"
    if width != d:
        with pytest.raises(ValueError, match="no flash kernel"):
            tflash.design(_DTYPES[dtype], d)


def _split_emulation(q, k, v, causal, scale, bk=64, dv=256, dc=64):
    """The column-split kernel's arithmetic in float32 on the CPU: for each
    slice of ``dv`` output columns, KV tiles of ``bk`` keys whose logits
    are summed over D in chunks of ``dc`` columns, an online softmax, and
    P.V over the slice's columns only."""
    b, s, h, d = q.shape
    qf, kf, vf = (x.to(torch.float32).transpose(1, 2) for x in (q, k, v))
    rows = torch.arange(s)[:, None]
    out = torch.zeros(b, h, s, d)
    for c0 in range(0, d, dv):
        m = torch.full((b, h, s, 1), -1e30)
        l = torch.zeros((b, h, s, 1))
        acc = torch.zeros((b, h, s, min(dv, d - c0)))
        for k0 in range(0, s, bk):
            kt, vt = kf[:, :, k0:k0 + bk], vf[:, :, k0:k0 + bk, c0:c0 + dv]
            x = sum(qf[..., d0:d0 + dc] @ kt[..., d0:d0 + dc].transpose(-1, -2)
                    for d0 in range(0, d, dc)) * scale
            if causal:
                x = x.masked_fill(rows < torch.arange(k0, k0 + kt.shape[2]),
                                  -1e30)
            m_new = torch.maximum(m, x.amax(-1, keepdim=True))
            p = torch.exp(x - m_new)
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(-1, keepdim=True)
            acc = acc * corr + p @ vt
            m = m_new
        out[..., c0:c0 + dv] = acc / l.clamp_min(1e-20)
    return out.transpose(1, 2).to(q.dtype)


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("d", [320, 512])
def test_flash_attention_wide_head_dims_equal_reference(d, causal):
    """D = 320 and 512 (beyond the one-pass kernels): ``ops`` on the CPU,
    and the split kernel's arithmetic at D padded to its chunk, against the
    reference's Pallas kernel in interpret mode, float32 within the
    reference's 2e-5."""
    (jq, jk, jv), (tq, tk, tv) = _qkv((1, 16, 2, d), "float32", seed=d)
    want = _f32(jops.flash_attention(jq, jk, jv, causal=causal, bq=8, bk=8))
    got = tops.flash_attention(tq, tk, tv, causal=causal, bq=8, bk=8)
    np.testing.assert_allclose(_f32(got), want, atol=2e-5, rtol=2e-5)
    width = tflash.padded_head_dim(d)
    pad = [torch.nn.functional.pad(t, (0, width - d)) for t in (tq, tk, tv)]
    emu = _split_emulation(*pad, causal, 1.0 / math.sqrt(d), bk=8)
    np.testing.assert_allclose(_f32(emu[..., :d]), want, atol=2e-5,
                               rtol=2e-5)


@pytest.mark.parametrize("d", [300, 1000])
def test_flash_split_emulation_pads_to_its_chunk(d):
    """A D off the 64-column chunk runs zero-padded with the true D's scale
    (1000 -> 1024: four slices, the last ragged at 232 columns), and gives
    the plain version at D; S off the 64-key tile."""
    rng = np.random.default_rng(d)
    q, k, v = (torch.tensor(rng.standard_normal((1, 70, 2, d)),
                            dtype=torch.float32) for _ in range(3))
    width = tflash.padded_head_dim(d)
    pad = [torch.nn.functional.pad(t, (0, width - d)) for t in (q, k, v)]
    for causal in (True, False):
        got = _split_emulation(*pad, causal, 1.0 / math.sqrt(d))
        assert not got[..., d:].any()
        torch.testing.assert_close(got[..., :d],
                                   tref.flash_attention_ref(q, k, v, causal),
                                   atol=2e-5, rtol=1e-4)


# the card tests' tolerances (tests/test_torch_cuda.py::FLASH_TOL)
CARD_TOL = {"bfloat16": (2e-2, 2e-2), "float16": (2e-3, 2e-3)}


def _tensor_core_emulation(q, k, v, causal, bk):
    """The wgmma kernel's arithmetic in float32 on the CPU: KV tiles of
    ``bk`` keys, an online softmax, P rounded to the input type (to
    nearest) before P.V, the normaliser summed from the unrounded P, the
    output rounded into the input type."""
    b, s, h, d = q.shape
    qf, kf, vf = (x.to(torch.float32).transpose(1, 2) for x in (q, k, v))
    m = torch.full((b, h, s, 1), -1e30)
    l = torch.zeros((b, h, s, 1))
    acc = torch.zeros((b, h, s, d))
    rows = torch.arange(s)[:, None]
    for k0 in range(0, s, bk):
        kt, vt = kf[:, :, k0:k0 + bk], vf[:, :, k0:k0 + bk]
        x = (qf @ kt.transpose(-1, -2)) / math.sqrt(d)
        if causal:
            x = x.masked_fill(rows < torch.arange(k0, k0 + kt.shape[2]), -1e30)
        m_new = torch.maximum(m, x.amax(-1, keepdim=True))
        p = torch.exp(x - m_new)
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1, keepdim=True)
        acc = acc * corr + p.to(q.dtype).to(torch.float32) @ vt
        m = m_new
    return (acc / l.clamp_min(1e-20)).transpose(1, 2).to(q.dtype)


@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
@pytest.mark.parametrize("s", [16, 48, 130, 320, 1000])
def test_flash_p_in_16_bits_holds_the_card_tolerance(s, dtype, d):
    """P rounded to 16 bits per KV tile (BK = 128, or 64 at D = 256, as
    ``csrc/flashattn.cu``) stays within the card tests' unchanged
    tolerance of the reference's float32 softmax, at their shapes."""
    (jq, jk, jv), (tq, tk, tv) = _qkv((2, s, 3, d), dtype, seed=s + d)
    atol, rtol = CARD_TOL[dtype]
    for causal in (True, False):
        got = _tensor_core_emulation(tq, tk, tv, causal,
                                     64 if d == 256 else 128)
        want = jref.flash_attention_ref(jq, jk, jv, causal=causal)
        np.testing.assert_allclose(_f32(got), _f32(want), atol=atol,
                                   rtol=rtol)
