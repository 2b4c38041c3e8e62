"""K1-K6 and X1-X3 CUDA kernels against their plain PyTorch versions, on the card
(K1 also at forced split counts and from a CUDA graph; K2 on both routes, at
a mixed link's chunk rows and at the dense prefill_extend's shape); the
engine's decode links from CUDA graphs against eager links, and its mixed
prefill + decode links against the CPU; the dense decode steps from CUDA
graphs against eager steps; prepare_reference on the card against the CPU;
the safetensors reader's tensors moved to the card bit for bit,
from_pretrained on the card giving the CPU load's turn; the LM training
path's loss and gradients against the CPU, and the offload step against
the resident one; the measuring scripts' shapes (K1 at b 32, K6 at the
fused and int8-head widths, the fused W8A8 step variants' tokens).

Marked `cuda`: each test skips without a CUDA device (a CUDA kernel has no
CPU mode).  Imports no JAX, so it runs where the port runs; there, skip
tests/conftest.py (it imports JAX):
`python -m pytest tests/test_torch_cuda.py -q --noconftest -p no:cacheprovider`.
"""

import pytest
import torch

from usdm_tpu_torch.engine.paged_ops import quant_kv_token
from usdm_tpu_torch.models import quant as Q
from usdm_tpu_torch.ops import flash_attention as FL
from usdm_tpu_torch.ops import fused_act as FA
from usdm_tpu_torch.ops import fused_ln as LN
from usdm_tpu_torch.ops import paged_attention as PA
from usdm_tpu_torch.ops import stream_matvec as SM


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False  # f32 plain versions in full f32
    return torch.device("cuda")


def _bf16_bound(want):
    """One bf16 ulp of the largest output (both sides round only their
    outputs to bf16) plus 1e-4 for f32 summation order."""
    return 2.0**-7 * want.float().abs().max().item() + 1e-4


def _paged_case(cuda, seq):
    g = torch.Generator(device=cuda).manual_seed(seq)
    hkv, grp, d, p, maxp = 8, 4, 128, 64, 128
    kp = torch.randn(hkv, 2 * maxp + 2, p, d, generator=g, device=cuda).bfloat16()
    vp = torch.randn(hkv, 2 * maxp + 2, p, d, generator=g, device=cuda).bfloat16()
    table = torch.randperm(2 * maxp + 1, generator=g, device=cuda)[: 2 * maxp]
    table = table.reshape(2, maxp).to(torch.int32).contiguous()
    lens = torch.tensor([seq, max(1, seq // 3)], dtype=torch.int32, device=cuda)
    q = torch.randn(2, hkv, grp, d, generator=g, device=cuda).bfloat16()
    return q, kp, vp, table, lens


@pytest.mark.cuda
@pytest.mark.parametrize("seq,window", [(1, 4096), (63, 4096), (64, 4096), (700, 4096),
                                        (4200, 4096), (4200, 512)])
def test_paged_kernel_matches_plain(cuda, seq, window):
    q, kp, vp, table, lens = _paged_case(cuda, seq)
    got = PA.paged_decode_attention(q, kp, vp, table, lens, window)
    want = PA.paged_decode_attention_reference(q, kp, vp, table, lens, window)
    assert (got.float() - want.float()).abs().max().item() <= _bf16_bound(want)


@pytest.mark.cuda
@pytest.mark.parametrize("wrong", [None, 511, 513])
def test_paged_bound_rejects_wrong_window(cuda, wrong):
    """The kernel run with its window dropped or off by one must fail the
    bound that the right window meets, where the window cuts most of a
    4200-token context."""
    q, kp, vp, table, lens = _paged_case(cuda, 4200)
    got = PA.paged_decode_attention(q, kp, vp, table, lens, wrong)
    want = PA.paged_decode_attention_reference(q, kp, vp, table, lens, 512)
    assert (got.float() - want.float()).abs().max().item() > _bf16_bound(want)


@pytest.mark.cuda
def test_flash_kernel_matches_plain(cuda):
    g = torch.Generator(device=cuda).manual_seed(0)
    c, s_ctx, start, n_valid = 512, 2048, 768, 300
    q = torch.randn(1, c, 32, 128, generator=g, device=cuda)
    k = torch.randn(1, s_ctx, 8, 128, generator=g, device=cuda)
    v = torch.randn(1, s_ctx, 8, 128, generator=g, device=cuda)
    qpos = (start + torch.arange(c, device=cuda))[None]
    kpos = torch.arange(s_ctx, device=cuda)[None]
    qseg = torch.where(torch.arange(c, device=cuda)[None] < n_valid, 0, -1)
    kseg = torch.where(kpos < start + n_valid, 0, -1)
    args = (q, k, v, qseg, kseg, qpos, kpos, True, 4096)
    got, got_lse = FL.flash_attention(*args, return_lse=True)
    want, want_lse = FL.flash_attention_reference(*args)
    assert (got - want).abs().max().item() <= 1e-4  # f32 both sides
    assert (got_lse - want_lse).abs().max().item() <= 1e-4  # padded rows: -1e30 on both


# the plain version's own bounds; a bf16 output is held against the plain
# version in f32 on the same bf16 inputs (both round only there: half a bf16
# ulp, 0.0156 below |y| = 8, plus the f32 difference)
_K3_BOUND = {torch.float32: 1e-4, torch.bfloat16: 3e-2}
_K3_STAGES = ((768, 1792), (384, 7168), (192, 14336), (96, 28672), (48, 57344), (24, 114688))


def _act_case(cuda, shape, dtype, seed, offset=0):
    """x [B, C, T] at `offset` elements into its storage (a row start off the
    16-byte grid when offset * itemsize is not a multiple of 16); alpha and
    beta of std 0.3, read as logs with log-scale and as they are without."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    n = shape[0] * shape[1] * shape[2]
    buf = torch.randn(n + offset, generator=g, device=cuda).to(dtype)
    x = buf[offset:].view(shape)
    alpha = torch.randn(shape[1], generator=g, device=cuda) * 0.3
    beta = torch.randn(shape[1], generator=g, device=cuda) * 0.3
    return x, alpha, beta


def _act_err(x, alpha, beta, logscale):
    got = FA.fused_activation1d(x, alpha, beta, logscale)
    want = FA.activation1d_reference(x.float(), alpha, beta, logscale)
    assert torch.isfinite(got.float()).all()
    return (got.float() - want.float()).abs().max().item(), got


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("snakebeta", [False, True])
@pytest.mark.parametrize("logscale", [False, True])
@pytest.mark.parametrize("tlen", [1, 2, 5, 11, 12, 13, FA.TILE - 1, FA.TILE, FA.TILE + 1, 5000])
def test_fused_act_kernel_matches_plain(cuda, tlen, logscale, snakebeta, dtype):
    """Every output, edges included, at B 2, lengths around the tile.  Without
    log-scale a b near 0 lifts a channel's outputs, and every f32 rounding in
    them, by 1/b (one f32 ulp is 6e-5 at 512), so each channel is held to the
    bound times its largest |y| (at least 1), against the f64 plain version."""
    x, alpha, beta = _act_case(cuda, (2, 24, tlen), dtype, tlen)
    beta = beta if snakebeta else None
    if logscale:
        assert _act_err(x, alpha, beta, True)[0] <= _K3_BOUND[dtype]
        return
    got = FA.fused_activation1d(x, alpha, beta, False).double()
    want = FA.activation1d_reference(x.double(), alpha.double(),
                                     None if beta is None else beta.double(), False)
    assert torch.isfinite(got).all()
    scale = want.abs().amax(dim=(0, 2)).clamp(min=1.0)
    assert ((got - want).abs().amax(dim=(0, 2)) <= _K3_BOUND[dtype] * scale).all()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("tlen,offset", [(1792, 1), (3444, 2), (1023, 3), (3444, 0)])
def test_fused_act_kernel_unaligned_rows(cuda, dtype, tlen, offset):
    """Rows that start off the 16-byte grid (a storage offset, or bf16 at a
    length that is a multiple of 4 but not 8) take the narrower vectors."""
    x, alpha, beta = _act_case(cuda, (2, 6, tlen), dtype, 7, offset)
    assert FA.vector_bytes(x, torch.empty_like(x)) < 16 or offset == 0
    assert _act_err(x, alpha, beta, True)[0] <= _K3_BOUND[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("stage", range(6))
def test_fused_act_kernel_stage_shapes(cuda, stage, dtype):
    """The six BigVGAN stage shapes of a 448-frame mel at B 1, snake-beta,
    log-scale, as the turn runs them."""
    ch, tlen = _K3_STAGES[stage]
    x, alpha, beta = _act_case(cuda, (1, ch, tlen), dtype, stage)
    assert _act_err(x, alpha, beta, True)[0] <= _K3_BOUND[dtype]


@pytest.mark.cuda
def test_fused_act_kernel_graph_replay_bit_equal(cuda):
    x, alpha, beta = _act_case(cuda, (1, 96, 28672), torch.float32, 3)
    eager = FA.fused_activation1d(x, alpha, beta, True)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = FA.fused_activation1d(x, alpha, beta, True)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, eager)


@pytest.mark.cuda
def test_fused_act_kernel_rejects_non_contiguous(cuda):
    x, alpha, beta = _act_case(cuda, (1, 8, 64), torch.float32, 4)
    before = FA.fused_activation1d.launches
    with pytest.raises(ValueError, match="contiguous"):
        FA.fused_activation1d(x.transpose(1, 2).contiguous().transpose(1, 2), alpha, beta, True)
    assert FA.fused_activation1d.launches == before


def _bwd_case(cuda, case, dtype, t_len):
    """Inputs of a K5 case: (a) the Voicebox training shape (16 heads, d 64,
    non-causal ALiBi, second row ragged); (b) an LM training shape (GQA 32/8,
    d 128, causal, window, three packed segments); (d) d 80, f32; (e) the
    tiny Voicebox's head dim 8 (4 heads, ALiBi)."""
    g = torch.Generator(device=cuda).manual_seed(7)
    b = 2
    h, hkv, d = {"a": (16, 16, 64), "b": (32, 8, 128), "d": (16, 16, 80), "e": (4, 4, 8)}[case]

    def rnd(*shape):
        return torch.randn(*shape, generator=g, device=cuda).to(dtype)

    q, k, v, do = rnd(b, t_len, h, d), rnd(b, t_len, hkv, d), rnd(b, t_len, hkv, d), rnd(b, t_len, h, d)
    pos = torch.arange(t_len, device=cuda)[None].expand(b, t_len)
    if case == "b":
        bounds = torch.tensor([0, t_len // 3, 2 * t_len // 3, t_len], device=cuda)
        seg = (torch.bucketize(pos, bounds[1:-1], right=True)).contiguous()
        pos = (pos - bounds[seg]).contiguous()
        flags = dict(causal=True, sliding_window=t_len // 4, alibi=False)
    else:
        seg = torch.where(pos < torch.tensor([[t_len], [2 * t_len // 3]], device=cuda), 0, -1)
        flags = dict(causal=False, sliding_window=None, alibi=case in "ae")
    return q, k, v, do, seg, pos, flags


def _bwd_pair(q, k, v, do, seg, pos, flags, kernel_flags=None):
    """(kernels' dq, dk, dv; the plain backward's), the plain versions
    rounding P and dS where the route of q's dtype does."""
    rnd = q.dtype != torch.float32
    o, lse = FL.flash_attention_reference(q, k, v, seg, seg, pos, pos, **flags,
                                          round_operands=rnd)
    want = FL.flash_attention_bwd_reference(q, k, v, o, lse, do, seg, seg, pos, pos,
                                            flags["causal"], flags["sliding_window"], None,
                                            flags["alibi"], round_operands=rnd)
    kf = kernel_flags or flags
    if kernel_flags is not None:  # the kernel's own forward under its flags
        o, lse = FL.flash_attention(q, k, v, seg, seg, pos, pos, return_lse=True, **kf)
    got = FL.flash_attention_bwd(q, k, v, o, lse, do, seg, seg, pos, pos, kf["causal"],
                                 kf["sliding_window"], None, kf["alibi"])
    return got, want


@pytest.mark.cuda
@pytest.mark.parametrize("case,dtype", [("a", torch.bfloat16), ("a", torch.float32),
                                        ("b", torch.bfloat16), ("d", torch.float32),
                                        ("e", torch.bfloat16), ("e", torch.float32)])
def test_flash_bwd_kernels_match_plain(cuda, case, dtype):
    """dq, dk, dv of the K5 kernels against the plain backward on the same
    saved forward, after K2's forward, which K5 consumes in training, against
    its plain version.  bf16 (the tensor-core route against the plain
    versions with round_operands): one bf16 ulp of each output's largest
    value (both sides multiply the same bf16 operands, accumulate in f32 and
    round P and dS at the same places; the sums differ in order); f32: 1e-4;
    the log-sum-exp (f32 both sides) within 1e-4."""
    q, k, v, do, seg, pos, flags = _bwd_case(cuda, case, dtype, 300)
    o, lse = FL.flash_attention(q, k, v, seg, seg, pos, pos, return_lse=True, **flags)
    want_o, want_lse = FL.flash_attention_reference(q, k, v, seg, seg, pos, pos, **flags,
                                                    round_operands=dtype != torch.float32)
    bound = _bf16_bound(want_o) if dtype == torch.bfloat16 else 1e-4
    assert (o.float() - want_o.float()).abs().max().item() <= bound
    assert (lse - want_lse).abs().max().item() <= 1e-4
    got, want = _bwd_pair(q, k, v, do, seg, pos, flags)
    for gg, ww in zip(got, want):
        assert gg.dtype == dtype
        bound = _bf16_bound(ww) if dtype == torch.bfloat16 else 1e-4
        assert (gg.float() - ww.float()).abs().max().item() <= bound


@pytest.mark.cuda
def test_flash_bwd_bound_rejects_missing_alibi(cuda):
    """The kernels run (forward and backward) with ALiBi off must fail the
    bound that the ALiBi gradient meets."""
    q, k, v, do, seg, pos, flags = _bwd_case(cuda, "a", torch.bfloat16, 300)
    got, want = _bwd_pair(q, k, v, do, seg, pos, flags, {**flags, "alibi": False})
    assert all((gg.float() - ww.float()).abs().max().item() > 4 * _bf16_bound(ww)
               for gg, ww in zip(got, want))


# ------------------------------------------------- K2/K5 tensor-core route
@pytest.mark.cuda
@pytest.mark.parametrize("d", [16, 32, 48, 64, 80, 96, 112, 128])
def test_mma_tile_products(cuda, d):
    """The parts of csrc/mma.cuh on one 64 x 64 tile: S = Q.K^T against
    torch.matmul of the same bf16 values in f32, and O = bf16(S).V against
    the matmul of the kernel's own rounded S.  Both sides multiply exactly
    (bf16 x bf16 fits f32) and differ only in the order of the f32 sums:
    1e-5 of the largest value."""
    g = torch.Generator(device=cuda).manual_seed(d)
    q, k, v = (torch.randn(64, d, generator=g, device=cuda).bfloat16() for _ in range(3))
    s_out, o_out = FL.mma_tile_products(q, k, v)
    want_s = q.float() @ k.float().t()
    assert (s_out - want_s).abs().max().item() <= 1e-5 * want_s.abs().max().item()
    want_o = s_out.bfloat16().float() @ v.float()
    assert (o_out - want_o).abs().max().item() <= 1e-5 * want_o.abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("mode", FL.MIX_MODES)
def test_mma_mix_rate_probe_runs(cuda, mode):
    """The rate probe of csrc/mma_harness.cu launches in every form and each
    thread of each block writes a finite sink; too little shared memory for
    its three tiles is refused before the launch."""
    out = FL.mma_mix_rate(mode, 3, 5, FL.MIX_TILE_BYTES, cuda)
    assert out.shape == (5 * 128,) and torch.isfinite(out).all()
    with pytest.raises(ValueError):
        FL.mma_mix_rate(mode, 3, 5, FL.MIX_TILE_BYTES - 16, cuda)


MMA_CASES = {
    # name: (B, Tq, Tk, H, Hkv, d, causal, window, alibi, segments)
    "voicebox d64 alibi ragged": (2, 300, 300, 16, 16, 64, False, None, True, 1),
    "d80 ragged": (2, 300, 300, 4, 4, 80, False, None, False, 1),
    "d96 ragged": (2, 300, 300, 4, 4, 96, False, None, False, 1),
    "d32 causal": (2, 130, 130, 4, 2, 32, True, None, False, 1),
    "d16 one row": (1, 1, 1, 2, 2, 16, True, None, False, 1),
    # the tiny models' head dim 8 (Voicebox, XLS-R), run at the 32-wide tiles
    "d8 alibi ragged": (2, 174, 174, 4, 4, 8, False, None, True, 1),
    "d8 gqa causal segments": (2, 300, 300, 4, 2, 8, True, None, False, 3),
    "lm gqa d128 causal window segments": (2, 500, 500, 32, 8, 128, True, 100, False, 3),
    "prefill chunk Tq != Tk": (1, 192, 700, 8, 2, 128, True, 4096, False, 1),
}


def _mma_case(cuda, name, dtype=torch.bfloat16):
    b, tq, tk, h, hkv, d, causal, window, alibi, n_seg = MMA_CASES[name]
    g = torch.Generator(device=cuda).manual_seed(len(name))

    def rnd(*shape):
        return torch.randn(*shape, generator=g, device=cuda).to(dtype)

    q, do = rnd(b, tq, h, d), rnd(b, tq, h, d)
    k, v = rnd(b, tk, hkv, d), rnd(b, tk, hkv, d)
    kpos = torch.arange(tk, device=cuda)[None].expand(b, tk)
    if tq != tk:  # a chunk of queries at start.., some of them padding
        start = tk - tq - 50
        qpos = (start + torch.arange(tq, device=cuda))[None].expand(b, tq)
        qseg = torch.where(torch.arange(tq, device=cuda)[None] < tq - 30, 0, -1).expand(b, tq)
        kseg = torch.where(kpos < start + tq - 30, 0, -1)
    elif n_seg > 1:  # packed segments, positions restart in each
        bounds = torch.tensor([0, tq // 3, 2 * tq // 3, tq], device=cuda)
        qseg = kseg = torch.bucketize(kpos, bounds[1:-1], right=True).contiguous()
        qpos = kpos = (kpos - bounds[qseg]).contiguous()
    else:  # ragged rows: the second is shorter
        lens = torch.tensor([[tq], [max(1, 2 * tq // 3)]], device=cuda)[:b]
        qpos = kpos
        qseg = kseg = torch.where(kpos < lens, 0, -1)
    flags = dict(causal=causal, sliding_window=window, alibi=alibi)
    return q, k, v, do, (qseg, kseg, qpos, kpos), flags


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(MMA_CASES))
def test_flash_mma_route_matches_rounded_plain(cuda, name):
    """The bf16 route (forward, dq, dk/dv) against the plain versions with
    round_operands=True at head dims 16..128, ragged lengths, GQA, window,
    packed segments, ALiBi and a chunk with Tq != Tk.  One bf16 ulp of each
    output's largest value + 1e-4 (same operands, same roundings, another
    summation order); log-sum-exp within 1e-4."""
    q, k, v, do, rows, flags = _mma_case(cuda, name)
    o, lse = FL.flash_attention(q, k, v, *rows, return_lse=True, **flags)
    want_o, want_lse = FL.flash_attention_reference(q, k, v, *rows, **flags, round_operands=True)
    assert torch.isfinite(o.float()).all()
    assert (o.float() - want_o.float()).abs().max().item() <= _bf16_bound(want_o)
    assert (lse - want_lse).abs().max().item() <= 1e-4
    got = FL.flash_attention_bwd(q, k, v, o, lse, do, *rows, flags["causal"],
                                 flags["sliding_window"], None, flags["alibi"])
    want = FL.flash_attention_bwd_reference(q, k, v, o, lse, do, *rows, flags["causal"],
                                            flags["sliding_window"], None, flags["alibi"],
                                            round_operands=True)
    for gg, ww in zip(got, want):
        assert gg.dtype == torch.bfloat16 and torch.isfinite(gg.float()).all()
        assert (gg.float() - ww.float()).abs().max().item() <= _bf16_bound(ww)


@pytest.mark.cuda
def test_flash_mma_route_rejects_missing_window(cuda):
    """The bf16 kernels run with the window off must miss, by 4x or more, the
    bound that the windowed run meets."""
    q, k, v, do, rows, flags = _mma_case(cuda, "lm gqa d128 causal window segments")
    want_o, lse = FL.flash_attention_reference(q, k, v, *rows, **flags, round_operands=True)
    want = FL.flash_attention_bwd_reference(q, k, v, want_o, lse, do, *rows, True, 100, None,
                                            False, round_operands=True)
    o, lse = FL.flash_attention(q, k, v, *rows, True, None, return_lse=True)
    got = FL.flash_attention_bwd(q, k, v, o, lse, do, *rows, True, None)
    assert (o.float() - want_o.float()).abs().max().item() > 4 * _bf16_bound(want_o)
    for gg, ww in zip(got, want):
        assert (gg.float() - ww.float()).abs().max().item() > 4 * _bf16_bound(ww)


@pytest.mark.cuda
def test_flash_mma_route_copies_misaligned_views(cuda):
    """bf16 views whose rows do not start on 16-byte boundaries (a storage
    offset of 4 elements; a time stride of d + 4) are copied by the wrapper
    and computed by the tensor-core route: same result as the aligned copy,
    bit for bit, and counted as mma launches."""
    q, k, v, do, rows, flags = _mma_case(cuda, "voicebox d64 alibi ragged")
    b, t, h, d = q.shape

    def shifted(x):  # same values, storage offset 4 elements (8 bytes)
        buf = torch.empty(x.numel() + 4, dtype=x.dtype, device=cuda)
        buf[4:].copy_(x.reshape(-1))
        return buf[4:].view(x.shape)

    def strided(x):  # same values, time stride H * d + 4
        buf = torch.empty(b, t, h * d + 4, dtype=x.dtype, device=cuda)
        buf[..., : h * d].copy_(x.reshape(b, t, h * d))
        return buf[..., : h * d].view(b, t, h, d)

    want_o, want_lse = FL.flash_attention(q, k, v, *rows, return_lse=True, **flags)
    want = FL.flash_attention_bwd(q, k, v, want_o, want_lse, do, *rows, False, None, None, True)
    for view in (shifted, strided):
        assert view(q).data_ptr() % 16 or view(q).stride(1) % 8
        before = FL.flash_attention.mma_launches
        o, lse = FL.flash_attention(view(q), view(k), view(v), *rows, return_lse=True, **flags)
        assert FL.flash_attention.mma_launches == before + 1
        assert torch.equal(o, want_o) and torch.equal(lse, want_lse)
        got = FL.flash_attention_bwd(view(q), view(k), view(v), o, lse, view(do), *rows, False,
                                     None, None, True)
        assert all(torch.equal(gg, ww) for gg, ww in zip(got, want))


@pytest.mark.cuda
def test_flash_mma_fully_masked_rows(cuda):
    """Query rows with no valid key (padding rows, and valid rows whose
    segment has no key) output 0, get lse = -1e30 + log(1e-30) and zero dq;
    keys no query attends get zero dk and dv."""
    q, k, v, do, (qseg, kseg, qpos, kpos), flags = _mma_case(cuda, "voicebox d64 alibi ragged")
    qseg = qseg.clone()
    qseg[0, 10:20] = 7  # valid queries of a segment that has no key
    kseg = kseg.clone()
    kseg[0, 100:164] = 9  # a whole tile of keys no query attends
    rows = (qseg, kseg, qpos, kpos)
    o, lse = FL.flash_attention(q, k, v, *rows, return_lse=True, **flags)
    dq, dk, dv = FL.flash_attention_bwd(q, k, v, o, lse, do, *rows, False, None, None, True)
    dead_q = torch.zeros_like(qseg, dtype=torch.bool)
    dead_q[0, 10:20] = True
    dead_q |= qseg < 0
    assert dead_q[1].any() and (o[dead_q] == 0).all() and (dq[dead_q] == 0).all()
    assert (lse.transpose(1, 2)[dead_q] < -9e29).all()
    assert (dk[0, 100:164] == 0).all() and (dv[0, 100:164] == 0).all()
    assert (dk[kseg < 0] == 0).all() and (dv[kseg < 0] == 0).all()
    want_o, _ = FL.flash_attention_reference(q, k, v, *rows, **flags, round_operands=True)
    assert (o.float() - want_o.float()).abs().max().item() <= _bf16_bound(want_o)


@pytest.mark.cuda
def test_flash_routes_by_dtype_and_counts(cuda):
    """bf16 calls count in launches and mma_launches; f32 calls in launches
    and tf32_launches (the 3xTF32 route of the forward, dq and dk/dv), and
    still meet 1e-4 against the plain version."""
    fns = (FL.flash_attention, FL.flash_attention_bwd_dq, FL.flash_attention_bwd_dkv)
    for dtype, mma in ((torch.bfloat16, 1), (torch.float32, 0)):
        q, k, v, do, rows, flags = _mma_case(cuda, "voicebox d64 alibi ragged", dtype)
        before = [(f.launches, f.mma_launches, f.tf32_launches) for f in fns]
        o, lse = FL.flash_attention(q, k, v, *rows, return_lse=True, **flags)
        got = FL.flash_attention_bwd(q, k, v, o, lse, do, *rows, False, None, None, True)
        assert [(f.launches, f.mma_launches, f.tf32_launches) for f in fns] == [
            (a + 1, b + mma, c + 1 - mma) for a, b, c in before]
        if dtype == torch.float32:
            want_o, want_lse = FL.flash_attention_reference(q, k, v, *rows, **flags)
            want = FL.flash_attention_bwd_reference(q, k, v, o, lse, do, *rows, False, None,
                                                    None, True)
            assert (o - want_o).abs().max().item() <= 1e-4
            assert all((gg - ww).abs().max().item() <= 1e-4 for gg, ww in zip(got, want))


# ------------------------------------------------------ K2 f32 route (3xTF32)
@pytest.mark.cuda
@pytest.mark.parametrize("name", list(MMA_CASES))
def test_flash_tf32_route_matches_plain(cuda, name):
    """The f32 forward on the tensor cores (3xTF32) at head dims 16..128
    (d 80 runs at width 96), ragged rows, GQA, window, packed segments,
    ALiBi and a prefill chunk with Tq != Tk: output and log-sum-exp within
    1e-4 of the f32 plain version and of the f64 one; one tf32 launch."""
    q, k, v, _, rows, flags = _mma_case(cuda, name, torch.float32)
    before = (FL.flash_attention.tf32_launches, FL.flash_attention.mma_launches)
    o, lse = FL.flash_attention(q, k, v, *rows, return_lse=True, **flags)
    assert (FL.flash_attention.tf32_launches, FL.flash_attention.mma_launches) == (
        before[0] + 1, before[1])
    want, want_lse = FL.flash_attention_reference(q, k, v, *rows, **flags)
    exact, _ = FL.flash_attention_reference(q.double(), k.double(), v.double(), *rows, **flags)
    assert torch.isfinite(o).all()
    assert (o - want).abs().max().item() <= 1e-4
    assert (o.double() - exact).abs().max().item() <= 1e-4
    assert (lse - want_lse).abs().max().item() <= 1e-4


@pytest.mark.cuda
def test_flash_tf32_route_beats_one_tf32_product(cuda):
    """Against the f64 plain version, the kernel's error is a small fraction
    of what one TF32 product per product gives (its plain emulation), which
    misses 1e-4: the route does take three."""
    q, k, v, _, rows, flags = _mma_case(cuda, "voicebox d64 alibi ragged", torch.float32)
    o = FL.flash_attention(q, k, v, *rows, **flags)
    exact, _ = FL.flash_attention_reference(q.double(), k.double(), v.double(), *rows, **flags)
    one, _ = FL.flash_attention_3xtf32_reference(q, k, v, *rows, **flags, terms=1)
    three, _ = FL.flash_attention_3xtf32_reference(q, k, v, *rows, **flags)
    err, err1 = ((x.double() - exact).abs().max().item() for x in (o, one))
    assert err1 > 1e-4 and err <= err1 / 20
    assert (three.double() - exact).abs().max().item() <= 1e-4


@pytest.mark.cuda
def test_flash_tf32_fully_masked_rows(cuda):
    """f32: query rows with no valid key (padding, and valid rows of a
    segment with no key) output 0 and lse -1e30; a whole key tile no query
    attends changes nothing."""
    q, k, v, _, (qseg, kseg, qpos, kpos), flags = _mma_case(cuda, "voicebox d64 alibi ragged",
                                                            torch.float32)
    qseg = qseg.clone()
    qseg[0, 10:20] = 7
    kseg = kseg.clone()
    kseg[0, 100:164] = 9
    rows = (qseg, kseg, qpos, kpos)
    o, lse = FL.flash_attention(q, k, v, *rows, return_lse=True, **flags)
    dead_q = torch.zeros_like(qseg, dtype=torch.bool)
    dead_q[0, 10:20] = True
    dead_q |= qseg < 0
    assert dead_q[1].any() and (o[dead_q] == 0).all()
    assert (lse.transpose(1, 2)[dead_q] < -9e29).all()
    want, want_lse = FL.flash_attention_reference(q, k, v, *rows, **flags)
    assert (o - want).abs().max().item() <= 1e-4
    assert (lse - want_lse).abs().max().item() <= 1e-4


# ---------------------------------------------------- K5 f32 route (3xTF32)
def _tf32_bwd(q, k, v, do, rows, flags):
    """The f32 plain forward's output and log-sum-exp, and the backward's
    arguments on them."""
    o, lse = FL.flash_attention_reference(q, k, v, *rows, **flags)
    return (q, k, v, o, lse, do, *rows, flags["causal"], flags["sliding_window"], None,
            flags["alibi"])


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(MMA_CASES))
def test_flash_bwd_tf32_route_matches_plain(cuda, name):
    """The f32 backward on the tensor cores (3xTF32) at head dims 8..128 (d 8
    and 16 at width 32, d 80 at 96), ragged rows, GQA, window, packed
    segments, ALiBi and a prefill chunk with Tq != Tk: dq, dk, dv within 1e-4
    of the f32 plain backward and of the f64 one on the same saved forward;
    one tf32 launch each."""
    args = _tf32_bwd(*_mma_case(cuda, name, torch.float32))
    fns = (FL.flash_attention_bwd_dq, FL.flash_attention_bwd_dkv)
    before = [(f.tf32_launches, f.mma_launches) for f in fns]
    got = FL.flash_attention_bwd(*args)
    assert [(f.tf32_launches, f.mma_launches) for f in fns] == [(a + 1, b) for a, b in before]
    want = FL.flash_attention_bwd_reference(*args)
    exact = FL.flash_attention_bwd_reference(*[x.double() for x in args[:6]], *args[6:])
    for gg, ww, ee in zip(got, want, exact):
        assert gg.dtype == torch.float32 and torch.isfinite(gg).all()
        assert (gg - ww).abs().max().item() <= 1e-4
        assert (gg.double() - ee).abs().max().item() <= 1e-4


@pytest.mark.cuda
def test_flash_bwd_tf32_route_beats_one_tf32_product(cuda):
    """Against the f64 plain backward, each of dq, dk and dv errs by at most
    1/20 of what one TF32 product per product gives (its plain emulation,
    which misses 1e-4), and the 3xTF32 emulation is within 1e-4: the kernels
    do take three."""
    args = _tf32_bwd(*_mma_case(cuda, "voicebox d64 alibi ragged", torch.float32))
    got = FL.flash_attention_bwd(*args)
    exact = FL.flash_attention_bwd_reference(*[x.double() for x in args[:6]], *args[6:])
    one = FL.flash_attention_bwd_3xtf32_reference(*args, terms=1)
    three = FL.flash_attention_bwd_3xtf32_reference(*args)
    for gg, g1, g3, ee in zip(got, one, three, exact):
        err, err1 = ((x.double() - ee).abs().max().item() for x in (gg, g1))
        assert err1 > 1e-4 and err <= err1 / 20
        assert (g3.double() - ee).abs().max().item() <= 1e-4


@pytest.mark.cuda
def test_flash_bwd_tf32_fully_masked_rows(cuda):
    """f32: query rows with no valid key (padding, and valid rows of a
    segment with no key) get zero dq; a whole key tile no query attends gets
    zero dk and dv; the rest within 1e-4 of the plain backward."""
    q, k, v, do, (qseg, kseg, qpos, kpos), flags = _mma_case(cuda, "voicebox d64 alibi ragged",
                                                            torch.float32)
    qseg = qseg.clone()
    qseg[0, 10:20] = 7
    kseg = kseg.clone()
    kseg[0, 100:164] = 9
    args = _tf32_bwd(q, k, v, do, (qseg, kseg, qpos, kpos), flags)
    dq, dk, dv = got = FL.flash_attention_bwd(*args)
    dead_q = torch.zeros_like(qseg, dtype=torch.bool)
    dead_q[0, 10:20] = True
    dead_q |= qseg < 0
    assert dead_q[1].any() and (dq[dead_q] == 0).all()
    assert (dk[0, 100:164] == 0).all() and (dv[0, 100:164] == 0).all()
    assert (dk[kseg < 0] == 0).all() and (dv[kseg < 0] == 0).all()
    want = FL.flash_attention_bwd_reference(*args)
    assert all((gg - ww).abs().max().item() <= 1e-4 for gg, ww in zip(got, want))


@pytest.mark.cuda
def test_flash_bwd_tf32_repeats_bit_for_bit(cuda):
    """Two runs of the f32 backward give the same bits: dk and dv are
    written once per block, with no atomics."""
    args = _tf32_bwd(*_mma_case(cuda, "lm gqa d128 causal window segments", torch.float32))
    first = FL.flash_attention_bwd(*args)
    again = FL.flash_attention_bwd(*args)
    assert all(torch.equal(a, b) for a, b in zip(first, again))


@pytest.mark.cuda
def test_flash_function_bf16_gradients(cuda):
    """autograd through `flash_attention` on bf16 CUDA leaves: the gradients
    it returns are the rounded plain backward's of the same saved forward,
    within one bf16 ulp of each gradient's largest value + 1e-4."""
    q, k, v, do, rows, flags = _mma_case(cuda, "lm gqa d128 causal window segments")
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    o, lse = FL.flash_attention(*leaves, *rows, return_lse=True, **flags)
    got = torch.autograd.grad(o, leaves, do)
    want = FL.flash_attention_bwd_reference(q, k, v, o.detach(), lse, do, *rows, True, 100,
                                            None, False, round_operands=True)
    for gg, ww in zip(got, want):
        assert (gg.float() - ww.float()).abs().max().item() <= _bf16_bound(ww)


@pytest.mark.cuda
@pytest.mark.parametrize("t_len", [1, 7, 1379])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("post_mask", [False, True])
def test_fused_ln_kernel_matches_plain(cuda, t_len, dtype, post_mask):
    """K4 at three row counts with ragged lengths, H 1024.  f32: 1e-5; bf16:
    two bf16 ulps of the largest output (the kernel rounds the normalized
    row, the product with w and the sum with b as the plain version does, and
    a flip of the first rounding can carry into the second)."""
    g = torch.Generator(device=cuda).manual_seed(t_len)
    x = torch.randn(3, t_len, 1024, generator=g, device=cuda).to(dtype)
    r = torch.randn(3, t_len, 1024, generator=g, device=cuda).to(dtype)
    w = (torch.randn(1024, generator=g, device=cuda) * 0.1 + 1.0).to(dtype)
    b = (torch.randn(1024, generator=g, device=cuda) * 0.1).to(dtype)
    lengths = torch.tensor([t_len, max(t_len // 2, 1), 0], device=cuda)
    got = LN.add_mask_ln(x, r, lengths, w, b, post_mask)
    want = LN.add_mask_ln_reference(x, r, lengths, w, b, post_mask)
    bound = 2.0**-6 * want.float().abs().max().item() if dtype == torch.bfloat16 else 1e-5
    assert (got.float() - want.float()).abs().max().item() <= bound


@pytest.mark.cuda
def test_fused_ln_takes_channel_first_rows(cuda):
    """The estimator's first layer passes x as a transposed [B, H, T] view
    (the positional conv's layout); the result must not depend on it."""
    g = torch.Generator(device=cuda).manual_seed(3)
    x = torch.randn(2, 256, 150, generator=g, device=cuda).transpose(1, 2)
    r = torch.randn(2, 150, 256, generator=g, device=cuda)
    w, b = torch.ones(256, device=cuda), torch.zeros(256, device=cuda)
    lengths = torch.tensor([150, 77], device=cuda)
    got = LN.add_mask_ln(x, r, lengths, w, b, True)
    want = LN.add_mask_ln_reference(x, r, lengths, w, b, True)
    assert (got - want).abs().max().item() <= 1e-5  # f32 both sides


def _ln_bwd_case(cuda, t_len, h, dtype, seed=0):
    g = torch.Generator(device=cuda).manual_seed(seed + t_len + h)
    x, r, go = (torch.randn(3, t_len, h, generator=g, device=cuda).to(dtype) for _ in range(3))
    w = (torch.randn(h, generator=g, device=cuda) * 0.1 + 1.0).to(dtype)
    b = (torch.randn(h, generator=g, device=cuda) * 0.1).to(dtype)
    lengths = torch.tensor([t_len, max(t_len // 2, 1), 0], device=cuda)
    return x, r, lengths, w, b, go


def _ln_bwd_bounds(x, r, lengths, w, go, post_mask, want):
    """dx, dr: 2^-6 * max|want| in bf16 (both round dn and ds; a flip of dn
    can carry), 1e-5 in f32.  dw, db: f32 sums over rows in another order,
    at most 1e-6 of the sum of the terms' magnitudes (a column's error grows
    with its terms, not with the sum, which cancels); bf16: two bf16 ulps of
    the largest (the one final rounding, and single terms moved by a flip of
    n or gy * n)."""
    bf16 = x.dtype == torch.bfloat16
    m = (torch.arange(x.shape[1], device=x.device)[None] < lengths[:, None]).to(x.dtype)[..., None]
    xf = ((x + r) * m).float()
    d = xf - xf.mean(-1, keepdim=True)
    n = d * torch.rsqrt((d * d).mean(-1, keepdim=True) + 1e-5)
    gy = (go * m if post_mask else go).float()
    mags = ((gy * n).abs().sum((0, 1)).max().item(), gy.abs().sum((0, 1)).max().item())
    dx_bound = 2.0**-6 * want[0].float().abs().max().item() if bf16 else 1e-5
    return [dx_bound, dx_bound] + [
        2.0**-6 * ww.float().abs().max().item() if bf16 else 1e-6 * mag
        for ww, mag in zip(want[2:], mags)]


@pytest.mark.cuda
@pytest.mark.parametrize("t_len", [1, 7, 1379])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("post_mask", [False, True])
def test_fused_ln_bwd_kernel_matches_plain(cuda, t_len, dtype, post_mask):
    """K4's backward kernel at three row counts with ragged lengths (a row of
    zero length too), H 1024, against add_mask_ln_backward_reference and
    against torch.autograd through add_mask_ln_reference, within
    _ln_bwd_bounds; dx and dr are one tensor."""
    x, r, lengths, w, b, go = _ln_bwd_case(cuda, t_len, 1024, dtype)
    before = LN.add_mask_ln_bwd.launches
    got = LN.add_mask_ln_bwd(x, r, lengths, w, go, post_mask)
    assert LN.add_mask_ln_bwd.launches == before + 1 and got[0] is got[1]
    want = LN.add_mask_ln_backward_reference(x, r, lengths, w, go, post_mask)
    leaves = [a.detach().requires_grad_() for a in (x, r, w, b)]
    out = LN.add_mask_ln_reference(leaves[0], leaves[1], lengths, leaves[2], leaves[3], post_mask)
    auto = torch.autograd.grad(out, leaves, go)
    for ref in (want, auto):
        bounds = _ln_bwd_bounds(x, r, lengths, w, go, post_mask, ref)
        for name, gg, ww, bound in zip(("dx", "dr", "dw", "db"), got, ref, bounds):
            assert gg.dtype == dtype and gg.shape == ww.shape, name
            assert (gg.float() - ww.float()).abs().max().item() <= bound, name


@pytest.mark.cuda
@pytest.mark.parametrize("h", [128, 256, 384, 640, 2048, 4096])
def test_fused_ln_bwd_kernel_widths(cuda, h):
    """Every width class of the backward (a row over 1, 2, 4 or 8 warps, and
    widths that leave a warp's last chunks idle), f32 and bf16."""
    for dtype in (torch.float32, torch.bfloat16):
        x, r, lengths, w, b, go = _ln_bwd_case(cuda, 50, h, dtype, seed=1)
        got = LN.add_mask_ln_bwd(x, r, lengths, w, go, True)
        want = LN.add_mask_ln_backward_reference(x, r, lengths, w, go, True)
        bounds = _ln_bwd_bounds(x, r, lengths, w, go, True, want)
        for name, gg, ww, bound in zip(("dx", "dr", "dw", "db"), got, want, bounds):
            assert (gg.float() - ww.float()).abs().max().item() <= bound, (name, dtype)


@pytest.mark.cuda
def test_fused_ln_bwd_repeats_bit_for_bit(cuda):
    """dw and db are summed in a fixed order (no float atomics): two runs
    give the same bits."""
    x, r, lengths, w, b, go = _ln_bwd_case(cuda, 1379, 1024, torch.float32)
    one = LN.add_mask_ln_bwd(x, r, lengths, w, go)
    two = LN.add_mask_ln_bwd(x, r, lengths, w, go)
    assert all(torch.equal(a, c) for a, c in zip(one, two))


@pytest.mark.cuda
def test_fused_ln_function_backward_runs_no_plain_op(cuda, monkeypatch):
    """On CUDA tensors the Function's backward launches the kernel: with
    both plain versions made to raise, a bf16 forward and backward through
    add_mask_ln still run, and their gradients match the plain backward."""
    x, r, lengths, w, b, go = _ln_bwd_case(cuda, 300, 1024, torch.bfloat16)
    want = LN.add_mask_ln_backward_reference(x, r, lengths, w, go, True)

    def refuse(*args, **kwargs):
        raise AssertionError("a plain version ran on CUDA tensors")

    monkeypatch.setattr(LN, "add_mask_ln_reference", refuse)
    monkeypatch.setattr(LN, "add_mask_ln_backward_reference", refuse)
    leaves = [a.detach().requires_grad_() for a in (x, r, w, b)]
    before = (LN.add_mask_ln.launches, LN.add_mask_ln_bwd.launches)
    out = LN.add_mask_ln(leaves[0], leaves[1], lengths.to(torch.int32), leaves[2], leaves[3],
                         True)
    got = torch.autograd.grad(out, leaves, go)
    assert (LN.add_mask_ln.launches, LN.add_mask_ln_bwd.launches) == (before[0] + 1,
                                                                      before[1] + 1)
    for name, gg, ww in zip(("dx", "dr", "dw", "db"), got, want):
        assert (gg.float() - ww.float()).abs().max().item() <= (
            2.0**-6 * ww.float().abs().max().item()), name


# ----------------------------------------------------------------- K1 int8
def _int8_case(cuda, seq, page, window):
    """GQA 32/8, d 128, bf16 queries over int8 pools with page-major f32
    scales (the engine's layout), two slots of lengths seq and seq // 3.
    Every scale slot the kernel must not read (pages outside the tables,
    rows past a slot's length or below its window) holds NaN."""
    g = torch.Generator(device=cuda).manual_seed(seq + page)
    hkv, grp, d = 8, 4, 128
    maxp = -(-4200 // page)
    nt = 2 * maxp + 2
    pools = []
    for _ in range(2):
        qv, sv = quant_kv_token(torch.randn(hkv, nt, page, d, generator=g, device=cuda))
        pools += [qv, sv.transpose(0, 1).contiguous()]  # scales [NT, Hkv, P]
    table = torch.randperm(nt - 1, generator=g, device=cuda)[: 2 * maxp]
    table = table.reshape(2, maxp).to(torch.int32).contiguous()
    lens = torch.tensor([seq, max(1, seq // 3)], dtype=torch.int32, device=cuda)
    q = torch.randn(2, hkv, grp, d, generator=g, device=cuda).bfloat16()
    read = torch.zeros(nt, page, dtype=torch.bool, device=cuda)
    pos = torch.arange(maxp * page, device=cuda)
    for b in range(2):
        n = int(lens[b])
        ok = (pos < n) & ((n - 1 - pos <= window) if window is not None else True)
        read[table[b].long()[pos[ok] // page], pos[ok] % page] = True
    poisoned = [t.masked_fill(~read[:, None, :], float("nan")) for t in (pools[1], pools[3])]
    return q, pools, poisoned, table, lens


@pytest.mark.cuda
@pytest.mark.parametrize("page", [64, 256])
@pytest.mark.parametrize("window", [4096, 512, None])
@pytest.mark.parametrize("seq", [1, 700, 4200])
def test_paged_int8_kernel_matches_plain(cuda, page, window, seq):
    """K1's int8 branch at respond()'s page 64 and serving's page 256.  The
    kernel folds the scales in f32; the plain version (usdm_tpu's
    semantics) rounds the dequantized K/V to q's dtype first.  Bounds: the
    kernel within one bf16 ulp of the largest output + 1e-4 of the plain
    version run on f32 queries (the same function with nothing rounded but
    the output); against the plain version on bf16 queries, that plus the
    effect of the K/V rounding, measured as the gap between the two plain
    runs.  The kernel gets the scale pools with NaN in every slot it must
    not read and stays finite."""
    q, (kq, ks, vq, vs), (ks_nan, vs_nan), table, lens = _int8_case(cuda, seq, page, window)
    got = PA.paged_decode_attention(q, kq, vq, table, lens, window, k_scales=ks_nan,
                                    v_scales=vs_nan)
    want = PA.paged_decode_attention_reference(q, kq, vq, table, lens, window, k_scales=ks,
                                               v_scales=vs)
    fold = PA.paged_decode_attention_reference(q.float(), kq, vq, table, lens, window,
                                               k_scales=ks, v_scales=vs)
    assert torch.isfinite(got.float()).all()
    bound = _bf16_bound(fold)
    assert (got.float() - fold).abs().max().item() <= bound
    rounding = (want.float() - fold).abs().max().item()
    assert (got.float() - want.float()).abs().max().item() <= bound + rounding


# ------------------------------------------------------------ K1 split-K
SPLIT_LENS = {1: [700], 8: [1, 700, 4200, 63, 64, 257, 2, 1500]}  # a length-1 slot at B 8


def _split_case(cuda, kv, page, b):
    """GQA 32/8, d 128, bf16 queries over bf16 or int8 pools (int8 with
    page-major f32 scales), shuffled tables of 4200 tokens, the slot lengths
    of SPLIT_LENS[b]; unread scale slots hold NaN (as in _int8_case) for the
    windowed and unwindowed calls alike: only rows inside the window of 512
    are marked readable, the unwindowed call gets the clean scales."""
    g = torch.Generator(device=cuda).manual_seed(b * 1000 + page)
    hkv, grp, d = 8, 4, 128
    maxp = -(-4200 // page)
    nt = b * maxp + 1
    table = torch.randperm(nt, generator=g, device=cuda)[: b * maxp]
    table = table.reshape(b, maxp).to(torch.int32).contiguous()
    lens = torch.tensor(SPLIT_LENS[b], dtype=torch.int32, device=cuda)
    q = torch.randn(b, hkv, grp, d, generator=g, device=cuda).bfloat16()
    if kv == "bf16":
        pools = [torch.randn(hkv, nt, page, d, generator=g, device=cuda).bfloat16()
                 for _ in range(2)]
        return q, pools, {}, table, lens
    pools, scales = [], []
    for _ in range(2):
        qv, sv = quant_kv_token(torch.randn(hkv, nt, page, d, generator=g, device=cuda))
        pools.append(qv)
        scales.append(sv.transpose(0, 1).contiguous())  # [NT, Hkv, P]
    return q, pools, {"k_scales": scales[0], "v_scales": scales[1]}, table, lens


def _poisoned(scales, table, lens, page, window):
    read = torch.zeros(scales["k_scales"].shape[0], page, dtype=torch.bool,
                       device=table.device)
    pos = torch.arange(table.shape[1] * page, device=table.device)
    for bi, n in enumerate(lens.tolist()):
        ok = (pos < n) & ((n - 1 - pos <= window) if window is not None else True)
        read[table[bi].long()[pos[ok] // page], pos[ok] % page] = True
    return {k: a.masked_fill(~read[:, None, :], float("nan")) for k, a in scales.items()}


@pytest.mark.cuda
@pytest.mark.parametrize("kv", ["bf16", "int8"])
@pytest.mark.parametrize("page", [64, 256])
@pytest.mark.parametrize("b", [1, 8])
@pytest.mark.parametrize("n_splits", [1, 2, 7, None])
@pytest.mark.parametrize("window", [None, 512])
def test_paged_split_kernel_matches_plain(cuda, kv, page, b, n_splits, window):
    """K1 at forced split counts and at the host's choice (None): against
    the split computation's plain version at the kernel's split count (the
    same function: one bf16 ulp of the largest output + 1e-4), and against
    the plain version with its bound (bf16 pools: that bound; int8: that
    bound on f32 queries plus the measured effect of rounding the
    dequantized K/V, as test_paged_int8_kernel_matches_plain states it)."""
    q, (kp, vp), scales, table, lens = _split_case(cuda, kv, page, b)
    seen = _poisoned(scales, table, lens, page, window) if scales else {}
    got = PA.paged_decode_attention(q, kp, vp, table, lens, window, n_splits=n_splits, **seen)
    assert torch.isfinite(got.float()).all()
    n = n_splits or PA.split_count(b, 8, table.shape[1], page, PA._sm_count(0))
    split = PA.paged_decode_attention_split_reference(q.float(), kp, vp, table, lens, n,
                                                      window, **scales)
    assert (got.float() - split).abs().max().item() <= _bf16_bound(split)
    want = PA.paged_decode_attention_reference(q, kp, vp, table, lens, window, **scales)
    if kv == "bf16":
        assert (got.float() - want.float()).abs().max().item() <= _bf16_bound(want)
    else:
        fold = PA.paged_decode_attention_reference(q.float(), kp, vp, table, lens, window,
                                                   **scales)
        rounding = (want.float() - fold).abs().max().item()
        assert (got.float() - want.float()).abs().max().item() <= _bf16_bound(fold) + rounding


@pytest.mark.cuda
@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_paged_split_graph_replay_equals_eager(cuda, kv):
    """One K1 call (B 8, page 64, window 512, the host's split count) runs
    with no host synchronization (sync debug mode "error") and, captured in
    a CUDA graph and replayed, equals the eager call bit for bit; each call
    counts one launch whatever its split count."""
    q, (kp, vp), scales, table, lens = _split_case(cuda, kv, 64, 8)
    fn = PA.paged_decode_attention
    count = "int8_launches" if scales else "launches"
    before = getattr(fn, count)
    torch.cuda.set_sync_debug_mode("error")
    try:
        eager = fn(q, kp, vp, table, lens, 512, **scales)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert getattr(fn, count) == before + 1
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn(q, kp, vp, table, lens, 512, **scales)
    out.zero_()
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, eager)


# ----------------------------------------------------------------- K6
SHAPES_7B = [(4096, 4096), (1024, 4096), (14336, 4096), (4096, 14336)]  # (Dout, Din)


def _qmv_case(cuda, m, dout, din):
    g = torch.Generator(device=cuda).manual_seed(m * 7 + dout)
    w = Q.quantize_weight(torch.randn(din, dout, generator=g, device=cuda) * 0.02)
    y = torch.randn(m, din, generator=g, device=cuda) * 2.0
    return y, w


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 8, 16])
@pytest.mark.parametrize("dout,din", SHAPES_7B)
def test_stream_qmv_kernel_matches_plain(cuda, m, dout, din):
    """K6 at the 7B decode projections.  f32 out: bit for bit (the int8
    activations, the int32 accumulators and the three IEEE operations of
    the epilogue are the same, so any difference is a wrong accumulator);
    bf16 activations and out: within one bf16 ulp of each value."""
    y, w = _qmv_case(cuda, m, dout, din)
    got = SM.stream_qmv(y, w, torch.float32)
    want = SM.stream_qmv_reference(y, w, torch.float32)
    assert torch.equal(got, want)
    yb = y.bfloat16()
    got_b = SM.stream_qmv(yb, w, torch.bfloat16).float()
    want_b = SM.stream_qmv_reference(yb, w, torch.bfloat16).float()
    ulp = torch.exp2(torch.floor(torch.log2(want_b.abs().clamp(min=1e-30))) - 7)
    assert ((got_b - want_b).abs() <= ulp).all()


def _assert_qmv_exact(y, w, route=None):
    """f32 out bit for bit; bf16 activations and out within one bf16 ulp
    (route: the kernel's plan, or a route forced through the test hook)."""
    def qmv(yy, dtype):
        return SM.stream_qmv(yy, w, dtype) if route is None else SM._stream_qmv_route(
            yy, w, dtype, route)
    got = qmv(y, torch.float32)
    assert torch.equal(got, SM.stream_qmv_reference(y, w, torch.float32))
    yb = y.bfloat16()
    got_b = qmv(yb, torch.bfloat16).float()
    want_b = SM.stream_qmv_reference(yb, w, torch.bfloat16).float()
    ulp = torch.exp2(torch.floor(torch.log2(want_b.abs().clamp(min=1e-30))) - 7)
    assert ((got_b - want_b).abs() <= ulp).all()


@pytest.mark.cuda
@pytest.mark.parametrize("m", list(range(1, 17)))
@pytest.mark.parametrize("dout,din", [(1024, 4096), (300, 1040)])
def test_stream_qmv_every_row_count(cuda, m, dout, din):
    """K6 at every M from 1 to 16 (one n-tile up to 8, two above; odd M
    leave columns of a tile idle), at a 7B shape and at Din 1040 (not a
    multiple of the kernel's 64-byte k-chunk) with Dout 300 (not a multiple
    of its 16-row tile)."""
    _assert_qmv_exact(*_qmv_case(cuda, m, dout, din))


@pytest.mark.cuda
def test_stream_qmv_zero_row_and_ties(cuda):
    """Row 0 all zero (its scale is the 1e-8 floor and every product 0);
    row 1 with amax 127, so its scale is 1 and its values on .5 ties
    quantize half to even, as the plain version does."""
    g = torch.Generator(device=cuda).manual_seed(11)
    w = Q.quantize_weight(torch.randn(1024, 512, generator=g, device=cuda) * 0.02)
    y = torch.randn(3, 1024, generator=g, device=cuda)
    y[0] = 0.0
    ties = torch.tensor([0.5, 1.5, 2.5, -0.5, -2.5, 126.5, -126.5, 127.0], device=cuda)
    y[1] = ties.repeat(128)
    qy, ys = SM.quantize_rows(y)
    assert ys[0].item() == pytest.approx(1e-8) and ys[1].item() == 1.0
    assert qy[1, :8].tolist() == [0, 2, 2, 0, -2, 126, -126, 127]
    _assert_qmv_exact(y, w)
    assert not SM.stream_qmv(y, w, torch.float32)[0].any()


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 2, 3, 8, 13, 16])
@pytest.mark.parametrize("dout,din", [(1024, 4096), (512, 1040), (4096, 14336)])
def test_stream_qmv_plans_agree(cuda, m, dout, din):
    """Both routes give the same bits (the integer sum has no order): the
    tensor cores, the row scales by the pre-pass and Din split over the
    planned cluster, at every M; __dp4a, the row scales found in its one
    launch, at 1-2 rows."""
    y, w = _qmv_case(cuda, m, dout, din)
    for route in SM.ROUTES:
        if route == 1 or m <= 2:
            _assert_qmv_exact(y, w, route)


@pytest.mark.cuda
def test_stream_qmv_graph_replay_and_allocations(cuda):
    """One call allocates only its output, and the call captured in a CUDA
    graph replays to the eager result's bits."""
    y, w = _qmv_case(cuda, 8, 1024, 4096)
    SM.stream_qmv(y, w)  # build and load the kernels first
    torch.cuda.synchronize()
    before = torch.cuda.memory_stats()["allocation.all.allocated"]
    eager = SM.stream_qmv(y, w, torch.float32)
    assert torch.cuda.memory_stats()["allocation.all.allocated"] == before + 1
    graph = torch.cuda.CUDAGraph()
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        with torch.cuda.graph(graph, stream=stream):
            out = SM.stream_qmv(y, w, torch.float32)
    torch.cuda.current_stream().wait_stream(stream)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, eager)


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 16, 17, 512])
def test_qmm_routes_on_the_card(cuda, m):
    """qmm on CUDA: K6 up to 16 rows, torch._int_mm above; both equal the
    plain version bit for bit in f32."""
    y, w = _qmv_case(cuda, m, 1024, 4096)
    before = SM.stream_qmv.launches
    got = Q.qmm(y, w)
    assert SM.stream_qmv.launches == before + (m <= SM.MAX_ROWS)
    assert torch.equal(got, SM.stream_qmv_reference(y, w, torch.float32))


@pytest.mark.cuda
def test_qmm_raises_without_a_route(cuda):
    """A shape that neither route takes raises; nothing dequantizes."""
    for m, din, dout in ((4, 24, 64), (17, 12, 64), (17, 64, 12)):
        y, w = _qmv_case(cuda, m, dout, din)
        with pytest.raises(ValueError, match="no CUDA route|Din a multiple"):
            Q.qmm(y, w)


# ----------------------------------------------------------------- X1-X3
from usdm_tpu_torch.ops import int4_matvec as I4  # noqa: E402
from usdm_tpu_torch.ops import matvec_io as MV  # noqa: E402
from usdm_tpu_torch.ops import stream_probe as SP  # noqa: E402


def _int8(g, *shape, lo=-127, hi=127, device="cuda"):
    return torch.randint(lo, hi, shape, generator=g, device=device, dtype=torch.int8)


@pytest.mark.cuda
@pytest.mark.parametrize("bf", [512, 1024])
@pytest.mark.parametrize("din,dout", [(4096, 14336), (14336, 4096), (260, 528)])
def test_mv_io_kernels_match_plain(cuda, din, dout, bf):
    """X1 at the probe's projections and a ragged shape (Dout not a multiple
    of the block's columns, Din not of the slice).  X1b bit for bit (exact
    int32, the same IEEE epilogue); X1a within one bf16 ulp of the largest
    output + 1e-4 (f32 sums in another order)."""
    g = torch.Generator(device=cuda).manual_seed(din + dout + bf)
    q = _int8(g, din, dout)
    s = (torch.rand(dout, generator=g, device=cuda) * 0.02).bfloat16()
    y = torch.randn(1, din, generator=g, device=cuda).bfloat16()
    qx = _int8(g, 1, din)
    before = (MV.mv_io_bf16.launches, MV.mv_io_i8.launches)
    got, want = MV.mv_io_bf16(y, q, s, bf), MV.mv_io_bf16_reference(y, q, s)
    assert (got.float() - want.float()).abs().max().item() <= _bf16_bound(want)
    assert torch.equal(MV.mv_io_i8(qx, q, s, bf), MV.mv_io_i8_reference(qx, q, s))
    assert (MV.mv_io_bf16.launches, MV.mv_io_i8.launches) == (before[0] + 1, before[1] + 1)


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 3, 16])
@pytest.mark.parametrize("dout,din", [(14336, 4096), (4096, 14336), (100, 96)])
def test_qmv4_kernel_matches_plain(cuda, m, dout, din):
    """X2 bit for bit in f32 (exact int32 accumulators, one IEEE multiply),
    at the probe's projections and a ragged one (Dout not a multiple of a
    block's 16 rows)."""
    g = torch.Generator(device=cuda).manual_seed(m + dout)
    wp = I4.pack_halves(_int8(g, dout, din, lo=-8, hi=8))
    qy = _int8(g, m, din)
    s = torch.rand(dout, generator=g, device=cuda) * 0.02
    before = I4.qmv4.launches
    assert torch.equal(I4.qmv4(qy, wp, s), I4.qmv4_reference(qy, wp, s))
    assert I4.qmv4.launches == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("loads", SP.LOADS)
@pytest.mark.parametrize("mode,bpad", [("dma_only", 1), ("dot", 1), ("dot", 8), ("dot", 32),
                                       ("vpu", 1), ("dot_bf16", 1)])
@pytest.mark.parametrize("d", [4096, 4112])
def test_stream_probe_kernel_matches_plain(cuda, mode, bpad, loads, d):
    """X3 over a 2-layer chain ([4096, D], tiles of 2048, 1024 and 128 rows;
    D 4112 leaves lanes without a whole chunk), every mode bit for bit:
    exact int32 rows, or vpu/dot_bf16's f32 rows in the kernel's order, and
    the same f32 tile and layer order."""
    g = torch.Generator(device=cuda).manual_seed(d + bpad + loads)
    ws = _int8(g, 2, 4096, d)
    x = _int8(g, bpad, d)
    for bf in (2048, 1024, 128):
        before = SP.stream_probe.launches
        got = sum(SP.stream_probe(x, w, mode, bf, loads) for w in ws)
        want = sum(SP.stream_probe_reference(x, w, mode, bf) for w in ws)
        assert SP.stream_probe.launches == before + 2
        assert torch.equal(got, want)


@pytest.mark.cuda
def test_graph_replays_count_launches(cuda):
    """A probe chain replayed from a CUDA graph (scripts.common.graphed):
    the eager warm-up call counts its launches, the capture none, and every
    replay the launches it makes."""
    from usdm_tpu_torch.scripts.common import graphed

    g = torch.Generator(device=cuda).manual_seed(1)
    w, x = _int8(g, 2048, 256), _int8(g, 1, 256)
    before = SP.stream_probe.launches
    replay = graphed(lambda: [SP.stream_probe(x, w, "dot", 1024, 8) for _ in range(3)], cuda)
    assert SP.stream_probe.launches == before + 3
    for _ in range(2):
        replay()
    torch.cuda.synchronize()
    assert SP.stream_probe.launches == before + 9


@pytest.mark.cuda
def test_probe_kernels_raise_on_what_they_do_not_take(cuda):
    """Shapes, types and layouts neither version takes raise before a launch."""
    g = torch.Generator(device=cuda).manual_seed(0)
    q, s = _int8(g, 256, 512), torch.ones(512, dtype=torch.bfloat16, device=cuda)
    y = torch.ones(1, 256, dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError):
        MV.mv_io_bf16(y, q, s, bf=256)
    with pytest.raises(ValueError):
        MV.mv_io_bf16(y[:, :254], q[:254], s)
    with pytest.raises(ValueError):
        MV.mv_io_i8(_int8(g, 2, 256), q, s)
    with pytest.raises(ValueError):
        MV.mv_io_i8(_int8(g, 1, 256), q.t().contiguous().t(), s)  # not contiguous
    wp = I4.pack_halves(_int8(g, 64, 256, lo=-8, hi=8))
    with pytest.raises(ValueError):
        I4.qmv4(_int8(g, 17, 256), wp, torch.ones(64, device=cuda))
    with pytest.raises(ValueError):
        I4.qmv4(_int8(g, 1, 240), wp[:, :120], torch.ones(64, device=cuda))
    with pytest.raises(TypeError):
        I4.qmv4(_int8(g, 1, 256), wp, torch.ones(64, device=cuda).bfloat16())
    w = _int8(g, 1024, 256)
    for x, mode, bf in ((_int8(g, 2, 256), "dot", 512), (_int8(g, 8, 256), "vpu", 512),
                        (_int8(g, 1, 256), "dot", 64), (_int8(g, 1, 256), "dot", 384)):
        with pytest.raises(ValueError):
            SP.stream_probe(x, w, mode, bf)
    with pytest.raises(ValueError):
        SP.stream_probe(_int8(g, 1, 256), w, "dot", 512, loads=3)


# --------------------------------------------- decode links from CUDA graphs
def _link_engine(cuda, w8a8, batch, window, eager, head_dim=32):
    """A tiny engine on the card (head_dim 32, or the tiny LM's own 16;
    prefill chunks of 32 rows, so K6 runs in the decode links alone): bf16
    weights and pools, or W8A8 projections over int8 pools."""
    from usdm_tpu_torch.core.config import EngineConfig, MistralConfig
    from usdm_tpu_torch.engine.paged import PagedEngine
    from usdm_tpu_torch.models import mistral as LM

    cfg = MistralConfig.tiny().replace(head_dim=head_dim, dtype="bfloat16",
                                       sliding_window=window)
    params = LM.init_params(cfg, torch.Generator(device=cuda).manual_seed(0), cuda)
    if w8a8:
        Q.quantize_llm_params(params)
    ecfg = EngineConfig(page_size=8, max_pages_per_seq=10, max_batch_size=batch,
                        prefill_chunk=32, decode_horizon=8,
                        kv_dtype="int8" if w8a8 else None)
    return PagedEngine(params, cfg, ecfg, device=cuda, eager_links=eager)


def _link_requests(batch, sampled):
    import numpy as np

    from usdm_tpu_torch.engine.paged import Request

    r = np.random.default_rng(3)
    allow = np.ones(291, bool)
    allow[:3] = False  # EOS 2 unreachable: every request runs its budget
    kw = dict(top_k=8, top_p=0.9, temperature=0.8) if sampled else {}
    return [Request(i, r.integers(3, 291, int(n)).tolist(), allow, 2, int(m), seed=i, **kw)
            for i, (n, m) in enumerate(zip(r.integers(5, 40, batch + 1),
                                           r.integers(12, 40, batch + 1)))]


@pytest.mark.cuda
@pytest.mark.parametrize("w8a8,sampled,batch,window", [
    (False, False, 1, None), (False, True, 4, 24), (False, False, 4, 24),
    (True, False, 4, None), (True, True, 1, 24), (True, False, 1, 24)])
def test_graphed_links_match_eager(cuda, w8a8, sampled, batch, window):
    """Each decode link replayed from a CUDA graph gives the eager links'
    tokens and KV pool (the trash pages aside: the capture's warm-up link
    writes there), greedy and sampled, B 1 and 4 (one request waits),
    window reclaim on and off, bf16 pools or W8A8 with int8 pools.  Every
    link is one replay, and each replay adds its K1 and K6 launches to
    the wrappers' counts, as the eager links count them."""
    _graphed_vs_eager_links(cuda, w8a8, sampled, batch, window, 32)


@pytest.mark.cuda
@pytest.mark.parametrize("w8a8,sampled,batch,window", [
    (False, False, 1, None), (False, True, 4, 24), (True, False, 4, None)])
def test_graphed_links_match_eager_head_dim_16(cuda, w8a8, sampled, batch, window):
    """test_graphed_links_match_eager at the tiny LM's own head_dim 16."""
    _graphed_vs_eager_links(cuda, w8a8, sampled, batch, window, 16)


def _graphed_vs_eager_links(cuda, w8a8, sampled, batch, window, head_dim):
    runs = []
    for eager in (False, True):
        eng = _link_engine(cuda, w8a8, batch, window, eager, head_dim)
        k1 = "int8_launches" if w8a8 else "launches"
        PA.paged_decode_attention.launches = PA.paged_decode_attention.int8_launches = 0
        SM.stream_qmv.launches = 0
        reqs = eng.run(_link_requests(batch, sampled))
        torch.cuda.synchronize()
        st = eng.stats()
        layers = eng.cfg.num_layers
        decode = st["steps"] - st["mixed_links"]  # mixed links run eagerly, K6-free
        assert st["steps"] > 0 and st["runahead_chains"] > 0
        assert st["graph_replays"] == (0 if eager else decode)
        assert getattr(PA.paged_decode_attention, k1) == layers * st["steps"]
        assert SM.stream_qmv.launches == (7 * layers * decode if w8a8 else 0)
        assert len(eng.free_pages) == eng.n_pages - 1
        keep = torch.ones(eng.kv.total_pages, dtype=torch.bool, device=cuda)
        keep[eng.n_pages - 1::eng.n_pages] = False
        pools = [p[:, keep] for p in (eng.kv.k_pages, eng.kv.v_pages)]
        if w8a8:
            pools += [s[keep] for s in (eng.kv.k_scales, eng.kv.v_scales)]
        runs.append(([r.output_ids for r in reqs], pools))
    (got, got_pools), (want, want_pools) = runs
    assert got == want and all(len(t) > 0 for t in got)
    assert all(torch.equal(a, b) for a, b in zip(got_pools, want_pools))


@pytest.mark.cuda
def test_link_capture_failure_raises(cuda, monkeypatch):
    """A link that synchronizes cannot be captured, and the engine raises
    instead of falling back to eager links."""
    from usdm_tpu_torch.engine import paged_ops

    real = paged_ops.paged_decode_step_chained

    def syncing(*args, **kw):
        out = real(*args, **kw)
        int(out[0].sum())  # a host sync: not legal under capture
        return out

    eng = _link_engine(cuda, False, 1, None, False)
    monkeypatch.setattr(paged_ops, "paged_decode_step_chained", syncing)
    with pytest.raises(RuntimeError):
        eng.run(_link_requests(1, False))
    assert eng.links.replays == 0


# ------------------------------------------ mixed prefill + decode on the card
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_rms_norm_rows_independent_of_row_count(cuda, dtype):
    """The mixed link normalizes its NPF*256 chunk rows in one call where a
    lone prefill chunk normalizes 256 (and its B decode rows apart, as a
    decode link does): a row's result must not depend on how many rows of
    at least 256 share the call, or mixed and alternating schedules would
    give other tokens."""
    from usdm_tpu_torch.models.mistral import rms_norm

    g = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn(8 * 256 + 16, 4096, generator=g, device=cuda).to(dtype)
    w = torch.randn(4096, generator=g, device=cuda).to(dtype)
    alone = rms_norm(x[:256], w, 1e-5)
    for n in (512, 1024, 2048, 8 * 256 + 16):
        assert torch.equal(rms_norm(x[:n], w, 1e-5)[:256], alone)


@pytest.mark.cuda
def test_flash_mixed_rows_match_plain(cuda):
    """K2 (bf16) at a mixed link's chunk rows: 8 rows of 256 queries, each
    with its own start and kv segment over a 768-key context, GQA 32/8, d
    128, window 4096, two rows fully padded (0 on both sides)."""
    g = torch.Generator(device=cuda).manual_seed(4)
    starts, valid = (0, 256, 0, 256, 0, 0, 256, 0), (256, 128, 256, 256, 0, 128, 256, 0)
    q = torch.randn(8, 256, 32, 128, generator=g, device=cuda).bfloat16()
    k, v = (torch.randn(8, 768, 8, 128, generator=g, device=cuda).bfloat16() for _ in range(2))
    start = torch.tensor(starts, device=cuda, dtype=torch.int32)[:, None]
    n_valid = torch.tensor(valid, device=cuda, dtype=torch.int32)[:, None]
    ar = torch.arange(256, device=cuda, dtype=torch.int32)[None]
    qseg = torch.where(ar < n_valid, 0, -1).to(torch.int32)
    kpos = torch.arange(768, device=cuda, dtype=torch.int32)[None].expand(8, 768).contiguous()
    kseg = torch.where(kpos < start + n_valid, 0, -1).to(torch.int32)
    args = (q, k, v, qseg, kseg, start + ar, kpos, True, 4096)
    got = FL.flash_attention(*args)
    want, _ = FL.flash_attention_reference(*args, round_operands=True)
    assert torch.isfinite(got.float()).all()
    assert (got.float() - want.float()).abs().max().item() <= _bf16_bound(want)
    assert torch.all(got[4] == 0) and torch.all(got[7] == 0)


def _mixed_engine(dev, params, w8a8, mixed, eager=False, dtype="float32"):
    """A tiny engine (head_dim 32 for K1, 128-token chunks so chunk rows take
    K2) with mixed links from one decoding slot on, 4 rows a link."""
    from usdm_tpu_torch.core.config import EngineConfig, MistralConfig
    from usdm_tpu_torch.engine.paged import PagedEngine

    cfg = MistralConfig.tiny().replace(head_dim=32, dtype=dtype)
    ecfg = EngineConfig(page_size=16, max_pages_per_seq=24, max_batch_size=4, prefill_chunk=128,
                        decode_horizon=8, kv_dtype="int8" if w8a8 else None,
                        mixed_prefill=mixed, mixed_min_decode=1, mixed_prefill_rows=4)
    return PagedEngine(params, cfg, ecfg, device=dev, eager_links=eager)


def _mixed_run(eng):
    """tests/test_torch_mixed.py's staggered harness: one request decodes,
    then four arrive at once -> (tokens per request, stats, real pools)."""
    import numpy as np

    from usdm_tpu_torch.engine.paged import Request

    r = np.random.default_rng(5)
    allow = np.ones(291, bool)
    allow[:3] = False  # EOS 2 unreachable: every request runs its budget
    reqs = [Request(i, r.integers(3, 291, int(n)).tolist(), allow, 2, 24)
            for i, n in enumerate((40, 300, 150, 260, 90))]
    eng.submit(reqs[0])
    for _ in range(3):
        eng.tick()
    for q in reqs[1:]:
        eng.submit(q)
    while eng.busy:
        eng.tick()
    eng.drain_inflight()
    assert len(eng.free_pages) == eng.n_pages - 1
    keep = torch.ones(eng.kv.total_pages, dtype=torch.bool, device=eng.kv.k_pages.device)
    keep[eng.n_pages - 1::eng.n_pages] = False
    return [q.output_ids for q in reqs], eng.stats(), [p[:, keep] for p in
                                                       (eng.kv.k_pages, eng.kv.v_pages)]


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["f32", "w8a8", "bf16"])
def test_mixed_link_on_card(cuda, kind):
    """Mixed links on the card (eager; chunk rows through K2, decode rows
    through K1, decode links from graphs) give the alternating schedule's
    tokens on the card, with f32, W8A8 (int8 pools) and bf16 weights; f32,
    also the CPU plain path's tokens, with KV within the bf16 bound.  Every
    decode link is one replay; every link, mixed or not, launches K1 once
    per layer."""
    from usdm_tpu_torch.core.config import MistralConfig
    from usdm_tpu_torch.core.tree import tree_map
    from usdm_tpu_torch.models import mistral as LM

    w8a8, dtype = kind == "w8a8", "bfloat16" if kind == "bf16" else "float32"
    cfg = MistralConfig.tiny().replace(head_dim=32)
    params = LM.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    card = tree_map(lambda a: a.to(cuda, LM.torch_dtype(dtype)), params)
    if w8a8:
        Q.quantize_llm_params(card)
    runs = {}
    for mixed in (True, False):
        k1 = "int8_launches" if w8a8 else "launches"
        PA.paged_decode_attention.launches = PA.paged_decode_attention.int8_launches = 0
        FL.flash_attention.launches = 0
        eng = _mixed_engine(cuda, card, w8a8, mixed, dtype=dtype)
        toks, st, pools = _mixed_run(eng)
        torch.cuda.synchronize()
        assert (st["mixed_links"] > 0) == mixed and st["mixed_rows"] >= st["mixed_links"]
        assert st["graph_replays"] == st["steps"] - st["mixed_links"]
        assert getattr(PA.paged_decode_attention, k1) == cfg.num_layers * st["steps"]
        assert FL.flash_attention.launches > 0
        runs[mixed] = toks, pools
    assert runs[True][0] == runs[False][0]
    if kind == "f32":
        toks, _, pools = _mixed_run(_mixed_engine("cpu", params, False, True))
        assert toks == runs[True][0]
        for got, want in zip(runs[True][1], pools):
            assert (got.cpu() - want).abs().max().item() <= _bf16_bound(want)


@pytest.mark.cuda
def test_step_multi_graphs_match_eager(cuda):
    """multi_impl="fused" (step_multi): its links replayed from CUDA graphs
    give the eager links' tokens and pools, and the chained decode's tokens."""
    runs = []
    for eager, impl in ((False, "fused"), (True, "fused"), (False, "chain")):
        eng = _link_engine(cuda, True, 4, None, eager)
        eng.multi_impl = impl
        reqs = eng.run(_link_requests(4, False))
        torch.cuda.synchronize()
        st = eng.stats()
        assert st["graph_replays"] == (0 if eager else st["steps"] - st["mixed_links"])
        assert ("multi_dispatch" in st["perf_s"]) == (impl == "fused")
        assert len(eng.free_pages) == eng.n_pages - 1
        keep = torch.ones(eng.kv.total_pages, dtype=torch.bool, device=cuda)
        keep[eng.n_pages - 1::eng.n_pages] = False
        runs.append(([r.output_ids for r in reqs], [p[:, keep] for p in
                                                    (eng.kv.k_pages, eng.kv.v_pages)]))
    assert runs[0][0] == runs[1][0] == runs[2][0]
    assert all(torch.equal(a, b) for a, b in zip(runs[0][1], runs[1][1]))


# ------------------------------------------------------ speculative rounds
@pytest.mark.cuda
@pytest.mark.parametrize("kv", ["bf16", "int8"])
@pytest.mark.parametrize("page", [64, 256])
@pytest.mark.parametrize("b,k", [(1, 4), (8, 3)])
@pytest.mark.parametrize("window", [None, 512])
def test_k1_verify_rows_equal_decode_link(cuda, kv, page, b, k, window):
    """K1 over a verify's B*(K+1) rows (row j*B + b reads slot b's pages up
    to kv_len lens_b + j + 1), with the split count the host picks for B
    rows, gives every row the bits of the decode link's K1 call over the B
    slots at that length."""
    _, (kp, vp), scales, table, lens = _split_case(cuda, kv, page, b)
    lens = torch.clamp(lens - (k + 1), min=0)
    g = torch.Generator(device=cuda).manual_seed(7)
    q = torch.randn(b * (k + 1), 8, 4, 128, generator=g, device=cuda).bfloat16()
    kv_len = torch.cat([lens + j + 1 for j in range(k + 1)]).to(torch.int32)
    n = PA.host_split_count(b, 8, table.shape[1], page, cuda)
    rows = PA.paged_decode_attention(q, kp, vp, table.repeat(k + 1, 1), kv_len, window,
                                     n_splits=n, **scales)
    for j in range(k + 1):
        link = PA.paged_decode_attention(q[j * b:(j + 1) * b].contiguous(), kp, vp, table,
                                         (lens + j + 1).to(torch.int32), window, **scales)
        assert torch.equal(rows[j * b:(j + 1) * b], link)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,k", [(1, 4), (4, 4), (8, 3)])
def test_verify_norm_and_tail_columns_equal_decode_link(cuda, dtype, b, k):
    """The verify forward's rms_norms and logits tail run per column: at a
    7B width each column's normalized rows and greedy tokens (full vocab,
    and an interval with an extra column) are the decode link's over its B
    rows, bit for bit."""
    from usdm_tpu_torch.engine import paged_ops as P
    from usdm_tpu_torch.models.mistral import rms_norm

    g = torch.Generator(device=cuda).manual_seed(b)
    x = torch.randn(b * (k + 1), 1, 4096, generator=g, device=cuda).to(dtype)
    w = torch.randn(4096, generator=g, device=cuda).to(dtype)
    params = {"lm_head": (torch.randn(42003, 4096, generator=g, device=cuda) * 0.02).to(dtype)}
    allow = torch.ones(b, 42003, dtype=torch.bool, device=cuda)
    active = torch.ones(b, dtype=torch.bool, device=cuda)
    cols = P._rms_norm_cols(x, w, 1e-5, k + 1)
    for j in range(k + 1):
        link = rms_norm(x[j * b:(j + 1) * b], w, 1e-5)
        assert torch.equal(cols[j * b:(j + 1) * b], link)
        for lslice in (None, (2000, 30000, 5)):
            got = P._logits_tail(params, cols[j * b:(j + 1) * b, 0], allow, active, lslice, None)
            want = P._logits_tail(params, link[:, 0], allow, active, lslice, None)
            assert torch.equal(got, want)


def _full_width(cuda, kind, layers=2):
    """Mistral-7B's widths (GQA 32/8, head 128, FFN 14336, vocab 42003) at
    `layers` layers, random weights: bf16 with W8A8 projections ("w8a8"),
    bf16 or f32."""
    from usdm_tpu_torch.core.config import MistralConfig
    from usdm_tpu_torch.models import mistral as LM

    cfg = MistralConfig().replace(num_layers=layers,
                                  dtype="float32" if kind == "f32" else "bfloat16")
    params = LM.init_params(cfg, torch.Generator(device=cuda).manual_seed(0), cuda)
    return cfg, Q.quantize_llm_params(params) if kind == "w8a8" else params


@pytest.mark.cuda
@pytest.mark.parametrize("kind,b,k,lslice", [
    ("w8a8", 1, 4, None), ("w8a8", 1, 4, (100, 30000, 5)), ("w8a8", 4, 4, None),
    ("w8a8", 3, 3, None), ("bf16", 1, 4, None), ("bf16", 4, 4, (100, 30000, 5)),
    ("f32", 1, 4, None), ("f32", 2, 3, None)])
def test_verify_columns_equal_decode_links(cuda, kind, b, k, lslice):
    """At the 7B widths (2 layers) the verify forward's column j is the
    decode link that consumes the same token at position lens + j: the same
    greedy token and the same K/V bits in the pool.  W8A8 over int8 pools
    (K6 at B*(K+1) <= 16 rows, torch._int_mm above, against K6 at B rows
    in the links), bf16 and f32 over pools of their dtype (one product over
    every column where its rows keep the link's bits, else one a column; each
    such decision holds for a probe captured in a CUDA graph)."""
    from usdm_tpu_torch.engine import paged_ops as P

    cfg, params = _full_width(cuda, kind)
    page, maxp = 64, 24
    n_pages = b * maxp + 1
    kv = P.PagedKV.create(cfg, n_pages, page, cuda, "int8" if kind == "w8a8" else None)
    g = torch.Generator(device=cuda).manual_seed(11)
    if kind == "w8a8":
        for pool, scales in ((kv.k_pages, kv.k_scales), (kv.v_pages, kv.v_scales)):
            qv, sv = quant_kv_token(torch.randn(pool.shape, generator=g, device=cuda))
            pool.copy_(qv)
            scales.copy_(sv.transpose(0, 1))
    else:
        for pool in (kv.k_pages, kv.v_pages):
            pool.copy_(torch.randn(pool.shape, generator=g, device=cuda))
    table = torch.arange(b * maxp, device=cuda, dtype=torch.int32).reshape(b, maxp)
    lens = torch.tensor([300, 1200, 65, 900][:b], device=cuda, dtype=torch.int32)
    tokens = torch.randint(3, cfg.vocab_size, (b, k + 1), generator=g, device=cuda)
    allow = torch.ones(b, cfg.vocab_size, dtype=torch.bool, device=cuda)
    active = torch.ones(b, dtype=torch.bool, device=cuda)
    pools = lambda c: [t for t in (c.k_pages, c.v_pages, c.k_scales, c.v_scales)  # noqa: E731
                       if t is not None]
    links = P.PagedKV(*(t.clone() for t in pools(kv)))
    got = P.paged_verify_step(params, kv, cfg, tokens, lens, table, active, allow, page, lslice)
    for j in range(k + 1):
        want = P.paged_decode_step(params, links, cfg, tokens[:, j].contiguous(), lens + j,
                                   table, active, allow, page, lslice)
        assert torch.equal(got[:, j], want)
    assert all(torch.equal(a, c) for a, c in zip(pools(kv), pools(links)))
    if kind != "w8a8":
        _row_decisions_hold_under_capture(cuda, params, b, k + 1)


def _row_decisions_hold_under_capture(cuda, params, b, k1):
    """The one-product-or-per-column decision the verify cached for each of
    the seven float projections (an eager probe on seed-0 rows) is what a
    probe on other rows gives when it is captured in a CUDA graph and
    replayed, as a round runs it."""
    from usdm_tpu_torch.engine import paged_ops as P

    decided = P.row_invariance()
    g = torch.Generator(device=cuda).manual_seed(5)
    seen = 0
    for name, w in params["layers"][0].items():
        if w.dim() != 2:
            continue
        key = (w.device, w.dtype, tuple(w.shape), b, k1)
        y = torch.randn(b * k1, 1, w.shape[0], generator=g, device=cuda).to(w.dtype)
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            full, cols = P.rows_probe(y, w, b)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(full, cols) == decided[key], (name, key)
        seen += 1
    assert seen == 7


def _spec_engine(cuda, w8a8, batch, draft, eager, spec_k=3):
    """_link_engine's tiny engine with a speculative draft: "ngram", "same"
    (the target itself) or "random" (another seed)."""
    from usdm_tpu_torch.core.config import EngineConfig, MistralConfig
    from usdm_tpu_torch.engine.paged import PagedEngine
    from usdm_tpu_torch.models import mistral as LM

    cfg = MistralConfig.tiny().replace(head_dim=32, dtype="bfloat16", sliding_window=24)

    def weights(seed):
        p = LM.init_params(cfg, torch.Generator(device=cuda).manual_seed(seed), cuda)
        return Q.quantize_llm_params(p) if w8a8 else p

    params = weights(0)
    d = {"ngram": "ngram", "same": (params, cfg), "random": (weights(9), cfg),
         None: None}[draft]
    ecfg = EngineConfig(page_size=8, max_pages_per_seq=10, max_batch_size=batch,
                        prefill_chunk=32, decode_horizon=8, spec_k=spec_k,
                        kv_dtype="int8" if w8a8 else None)
    return PagedEngine(params, cfg, ecfg, device=cuda, draft=d, eager_links=eager)


def _spec_requests(batch, cyclic):
    import numpy as np

    from usdm_tpu_torch.engine.paged import Request

    r = np.random.default_rng(4)
    allow = np.ones(291, bool)
    allow[:3] = False  # EOS 2 unreachable: every request runs its budget
    if cyclic:  # greedy decode under a 2-token mask cycles: ngram accepts
        allow[:] = False
        allow[40:42] = True
    return [Request(i, r.integers(3, 291, int(n)).tolist(), allow, 2, int(m))
            for i, (n, m) in enumerate(zip(r.integers(5, 30, batch + 1),
                                           r.integers(16, 40, batch + 1)))]


def _real_pages(eng, kv):
    keep = torch.ones(kv.total_pages, dtype=torch.bool, device=kv.k_pages.device)
    keep[eng.n_pages - 1::eng.n_pages] = False
    out = [p[:, keep] for p in (kv.k_pages, kv.v_pages)]
    if kv.quantized:
        out += [s[keep] for s in (kv.k_scales, kv.v_scales)]
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("w8a8,batch,draft,cyclic", [
    (False, 1, "ngram", True), (False, 4, "ngram", False), (True, 1, "ngram", True),
    (True, 4, "same", False), (False, 1, "random", False), (True, 1, "same", True)])
def test_graphed_rounds_match_eager(cuda, w8a8, batch, draft, cyclic):
    """Each speculative round replayed from a CUDA graph gives the eager
    rounds' tokens and pools (the draft's too), B 1 and 4, bf16 or W8A8
    with int8 pools, ngram or a draft model.  Every decode link and round
    is one replay; an ngram round launches K1 once a target layer, a draft
    round K+1 times a draft layer and once a target layer, a mirrored step
    once a layer of each, a mixed link (batch 4 admits a fifth request while
    three slots decode) once a target layer; a W8A8 round launches K6 7
    times a layer of each forward whose rows K6 takes (at most 16).  The
    tokens equal the plain engine's (spec_k 0) on the card."""
    runs = []
    for eager in (False, True):
        eng = _spec_engine(cuda, w8a8, batch, draft, eager)
        k1 = "int8_launches" if w8a8 else "launches"
        PA.paged_decode_attention.launches = PA.paged_decode_attention.int8_launches = 0
        SM.stream_qmv.launches = 0
        reqs = eng.run(_spec_requests(batch, cyclic))
        torch.cuda.synchronize()
        st = eng.stats()
        lt = eng.cfg.num_layers
        ld = eng.draft_cfg.num_layers if eng.draft_cfg is not None else 0
        rounds, mixed = st["spec_rounds"], st["mixed_links"]
        links = st["steps"] - rounds - mixed  # decode links (mirrored steps with a draft)
        assert rounds > 0 and (mixed == 0 or draft == "ngram")
        assert st["graph_replays"] == (0 if eager else st["steps"] - mixed)
        kk = eng.ecfg.spec_k + 1
        target = lt * st["steps"]
        if draft == "ngram":
            assert getattr(PA.paged_decode_attention, k1) == target
        else:  # draft pools are bf16: their K1 launches count under `launches`
            drafted = ld * (links + kk * rounds)
            if w8a8:
                assert PA.paged_decode_attention.int8_launches == target
                assert PA.paged_decode_attention.launches == drafted
            else:
                assert PA.paged_decode_attention.launches == target + drafted
        if w8a8:
            verify = 7 * lt * rounds if batch * kk <= 16 else 0
            drafts = 7 * ld * (links + kk * rounds)
            assert SM.stream_qmv.launches == 7 * lt * links + verify + drafts
        assert len(eng.free_pages) == eng.n_pages - 1
        pools = _real_pages(eng, eng.kv)
        if eng.draft_kv is not None:
            pools += _real_pages(eng, eng.draft_kv)
        runs.append(([r.output_ids for r in reqs], pools))
    (got, got_pools), (want, want_pools) = runs
    assert got == want and all(len(t) > 0 for t in got)
    assert all(torch.equal(a, b) for a, b in zip(got_pools, want_pools))
    plain = _spec_engine(cuda, w8a8, batch, None, False, spec_k=0)
    assert [r.output_ids for r in plain.run(_spec_requests(batch, cyclic))] == got


@pytest.mark.cuda
def test_round_capture_failure_raises(cuda, monkeypatch):
    """A round that synchronizes cannot be captured, and the engine raises
    instead of falling back to eager rounds."""
    from usdm_tpu_torch.engine import paged_ops

    real = paged_ops.paged_ngram_round

    def syncing(*args, **kw):
        out = real(*args, **kw)
        int(out[1].sum())  # a host sync: not legal under capture
        return out

    eng = _spec_engine(cuda, False, 1, "ngram", False)
    monkeypatch.setattr(paged_ops, "paged_ngram_round", syncing)
    with pytest.raises(RuntimeError):
        eng.run(_spec_requests(1, True))
    assert eng.spec_rounds == 0


# ------------------------------------------ the dense dialog path on the card
def _dense_lm(cuda, kind):
    """A tiny LM on the card (head_dim 32): f32, bf16, or bf16 with W8A8
    projections (K6 inside the decode step)."""
    from usdm_tpu_torch.core.config import MistralConfig
    from usdm_tpu_torch.models import mistral as LM

    cfg = MistralConfig.tiny().replace(head_dim=32, dtype="float32" if kind == "f32"
                                       else "bfloat16")
    params = LM.init_params(cfg, torch.Generator(device=cuda).manual_seed(0), cuda)
    if kind == "w8a8":
        Q.quantize_llm_params(params)
    return params, cfg


def _dense_run(cuda, params, cfg, graphs, top_k):
    """Two ragged rows decoding 40 tokens with an EOS one row reaches ->
    (tokens, lengths, the loop)."""
    from usdm_tpu_torch.engine import generate as G
    from usdm_tpu_torch.models import mistral as LM

    g = torch.Generator(device=cuda).manual_seed(1)
    ids = torch.randint(3, cfg.vocab_size, (2, 24), generator=g, device=cuda)
    lens = torch.tensor([24, 11], device=cuda)
    allow = torch.ones(cfg.vocab_size, dtype=torch.bool, device=cuda)
    allow[:3] = False
    loop = G.DenseLoop(params, cfg, LM.KVCache.create(cfg, 2, 80, cuda), graphs=graphs)
    eos = int(LM.forward(params, cfg, ids[:1, :24])[0, -1, 3:].argmax()) + 3
    tokens, lengths = G.generate(params, cfg, ids, lens, allow, eos, max_new_tokens=40,
                                 cache_len=80, loop=loop, top_k=top_k, temperature=1.3,
                                 generator=torch.Generator(device=cuda).manual_seed(2))
    return tokens, lengths, loop


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["f32", "bf16", "w8a8"])
@pytest.mark.parametrize("top_k", [1, 8])
def test_dense_graph_steps_match_eager(cuda, kind, top_k):
    """Each dense decode step replayed from a CUDA graph equals the eager
    step bit for bit: tokens, lengths and the whole cache; one replay a
    step; W8A8 steps launch K6 7 times a layer from the graph."""
    params, cfg = _dense_lm(cuda, kind)
    before = SM.stream_qmv.launches
    got = _dense_run(cuda, params, cfg, True, top_k)
    k6 = SM.stream_qmv.launches - before
    want = _dense_run(cuda, params, cfg, False, top_k)
    (gt, gl, gloop), (wt, wl, wloop) = got, want
    assert torch.equal(gt, wt) and torch.equal(gl, wl)
    assert torch.equal(gloop.cache.k, wloop.cache.k) and torch.equal(gloop.cache.v, wloop.cache.v)
    assert gloop.replays == gloop.steps > 0 and wloop.replays == 0
    assert gloop.syncs <= -(-gloop.steps // 16) + 1
    if kind == "w8a8":
        assert k6 == 7 * cfg.num_layers * gloop.steps


@pytest.mark.cuda
def test_dense_capture_failure_raises(cuda, monkeypatch):
    """A decode step that synchronizes cannot be captured, and the loop
    raises instead of stepping eagerly."""
    from usdm_tpu_torch.models import mistral as LM

    real = LM.decode_step

    def syncing(*args, **kw):
        out = real(*args, **kw)
        float(out[0].sum())  # a host sync: not legal under capture
        return out

    params, cfg = _dense_lm(cuda, "bf16")
    monkeypatch.setattr(LM, "decode_step", syncing)
    with pytest.raises(RuntimeError):
        _dense_run(cuda, params, cfg, True, 1)


@pytest.mark.cuda
def test_flash_at_dense_prefill_extend_shape(cuda):
    """K2 (bf16) where the dense prefill_extend calls it: B 1, 256 queries at
    offset 320 against an 8,192-slot cache whose keys past 576 are padding
    (segment -1), window 4096, GQA 32/8, d 128 -- the shape whose tiles a
    flat-index skip would get wrong; against the plain version with
    round_operands at the bf16 bound."""
    g = torch.Generator(device=cuda).manual_seed(0)
    t, s, off = 256, 8192, 320
    q = torch.randn(1, t, 32, 128, generator=g, device=cuda).bfloat16()
    k, v = (torch.randn(1, s, 8, 128, generator=g, device=cuda).bfloat16() for _ in range(2))
    qpos = (off + torch.arange(t, device=cuda))[None]
    qseg = torch.zeros(1, t, dtype=torch.int32, device=cuda)
    kpos = torch.arange(s, device=cuda)[None]
    kseg = torch.where(kpos < off + t, 0, -1).to(torch.int32)
    args = (q, k, v, qseg, kseg, qpos, kpos, True, 4096, None, False)
    got = FL.flash_attention(*args)
    want, _ = FL.flash_attention_reference(*args, round_operands=True)
    assert (got.float() - want.float()).abs().max().item() <= _bf16_bound(want)


@pytest.mark.cuda
def test_prepare_reference_on_card_matches_cpu(cuda, tmp_path):
    """prepare_reference on the card with TF32 off (the cuda fixture): the
    CPU's units, and its normalized mel within 1e-4 (cuFFT against the
    CPU's FFT, f32; the filterbank product in f64 on both)."""
    import numpy as np

    from usdm_tpu_torch.audio.wav import write_wav
    from usdm_tpu_torch.core.config import MelConfig, XlsrConfig
    from usdm_tpu_torch.core.tree import tree_map
    from usdm_tpu_torch.engine.synthesis import prepare_reference
    from usdm_tpu_torch.models import xlsr as XL

    path = str(tmp_path / "ref.wav")
    write_wav(path, (np.random.default_rng(0).standard_normal(3 * 22050) * 0.2)
              .astype(np.float32), 22050)
    # head dim 16, which K2's f32 route takes: a 3 s clip is past XLS-R's
    # 2048-frame flash gate at the tiny extractor's 20x stride
    xcfg = XlsrConfig.tiny().replace(num_clusters=32, hidden_size=64, intermediate_size=128)
    xp = XL.init_params(xcfg, torch.Generator().manual_seed(0), "cpu")
    want_u, want_m = prepare_reference(path, xp, xcfg, MelConfig(), device="cpu")
    xp_card = tree_map(lambda a: a.to(cuda), xp)
    got_u, got_m = prepare_reference(path, xp_card, xcfg, MelConfig(), device=cuda)
    assert np.array_equal(got_u, want_u) and got_m.is_cuda
    assert (got_m.cpu() - want_m).abs().max().item() <= 1e-4


# ------------------------------------------------------------ checkpoint I/O
@pytest.mark.cuda
def test_safetensors_reader_to_card_bit_equal(cuda, tmp_path):
    """bf16, f16 and int8 tensors written from the card by the port's
    safetensors writer, read back by its reader (host tensors on the mapped
    file) and moved to the card: bit-equal; a Mistral directory loads on
    the card to the CPU load's tensors."""
    from usdm_tpu_torch.core import checkpoint as CK
    from usdm_tpu_torch.core import safetensors as ST
    from usdm_tpu_torch.core.config import MistralConfig
    from usdm_tpu_torch.core.tree import tree_leaves
    from usdm_tpu_torch.models import mistral as LM

    g = torch.Generator(device=cuda).manual_seed(0)
    src = {"bf16": torch.randn(33, 65, generator=g, device=cuda).bfloat16(),
           "f16": torch.randn(5, 129, generator=g, device=cuda).half(),
           "i8": torch.randint(-128, 128, (7, 9), generator=g, device=cuda).to(torch.int8)}
    path = str(tmp_path / "t.safetensors")
    ST.save_file(src, path)
    back = ST.load_file(path)
    for k, t in src.items():
        assert back[k].device.type == "cpu" and back[k].dtype == t.dtype
        assert torch.equal(back[k].to(cuda), t), k
    cfg = MistralConfig.tiny(vocab_size=300).replace(head_dim=32, dtype="bfloat16")
    params = LM.init_params(cfg, torch.Generator(device=cuda).manual_seed(1), cuda)
    CK.save_mistral_hf(str(tmp_path / "lm"), params, cfg)
    on_card, _ = CK.load_mistral(str(tmp_path / "lm"), device=cuda)
    on_cpu, _ = CK.load_mistral(str(tmp_path / "lm"), device="cpu")
    for a, b, c in zip(tree_leaves(on_card), tree_leaves(on_cpu), tree_leaves(params)):
        assert a.device.type == "cuda" and torch.equal(a, b.to(cuda)) and torch.equal(a, c)


def _tiny_checkpoints(root):
    """A small random pipeline on the CPU (tiny_random's configs at head
    dims the kernels take, the full 10,000-unit token space) exported to the
    reference's formats under `root` -> (source pipeline, from_pretrained's
    paths)."""
    import numpy as np

    from chip_smoke import save_xlsr
    from usdm_tpu_torch.core import checkpoint as CK
    from usdm_tpu_torch.core.config import (BigVGANConfig, MistralConfig, VoiceboxConfig,
                                            XlsrConfig)
    from usdm_tpu_torch.core.tokenizer import UsdmTokenizer
    from usdm_tpu_torch.pipeline import UsdmPipeline

    tok = UsdmTokenizer.build_test(num_units=10000)
    src = UsdmPipeline.random_init(
        tok, MistralConfig.tiny(vocab_size=tok.vocab_size).replace(head_dim=32),
        XlsrConfig.tiny().replace(num_clusters=32, hidden_size=64, intermediate_size=128),
        VoiceboxConfig.tiny().replace(n_tokens=10000, n_feats=80, hidden_size=64,
                                      intermediate_size=128),
        BigVGANConfig.tiny().replace(num_mels=80), "cpu", seed=0, max_new_tokens=16)
    CK.save_mistral_hf(str(root / "llm"), src.lm_params, src.lm_cfg, tok, save_dtype="float32")
    save_xlsr(str(root / "xlsr"), src.xlsr_params, src.xlsr_cfg, layout="hf")
    np.save(root / "kmeans.npy", src.xlsr_params["centroids"].numpy())
    CK.save_voicebox_hub(str(root / "vb"), src.decoder.voicebox_params, src.decoder.voicebox_cfg)
    CK.save_bigvgan_generator(str(root / "bv"), src.decoder.vocoder_params,
                              src.decoder.vocoder_cfg)
    return src, dict(llm_dir=str(root / "llm"), xlsr_dir=str(root / "xlsr"),
                     kmeans_path=str(root / "kmeans.npy"), voicebox_dir=str(root / "vb"),
                     bigvgan_dir=str(root / "bv"))


@pytest.mark.cuda
def test_from_pretrained_on_card_gives_cpu_tokens(cuda, tmp_path):
    """from_pretrained of small exported directories on the card (f32 LM,
    the float and the default W8A8 Voicebox) gives the CPU load's turn:
    the same user units and stage tokens."""
    import dataclasses

    import numpy as np

    from usdm_tpu_torch.audio.wav import write_wav
    from usdm_tpu_torch.pipeline import UsdmPipeline

    src, dirs = _tiny_checkpoints(tmp_path)
    wav = str(tmp_path / "user.wav")
    write_wav(wav, (np.random.default_rng(5).standard_normal(48000) * 0.1).astype(np.float32),
              16000)
    for vb_int8 in (False, True):
        results = []
        for dev in ("cpu", cuda):
            pipe = UsdmPipeline.from_pretrained(**dirs, lm_dtype="float32", vb_int8=vb_int8,
                                                device=dev)
            pipe = dataclasses.replace(pipe, xlsr_cfg=pipe.xlsr_cfg.replace(
                output_layer=src.xlsr_cfg.output_layer), max_new_tokens=16)
            try:
                results.append(dataclasses.asdict(pipe.respond(wav, n_timesteps=6, seed=2)))
            finally:
                pipe.close()
        assert results[0] == results[1] and results[0]["agent_units"], vb_int8


def test_from_pretrained_raises_without_card(tmp_path):
    """from_pretrained's default device is the card: without one it raises
    before reading anything."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from usdm_tpu_torch.pipeline import UsdmPipeline

    missing = str(tmp_path / "none")
    with pytest.raises(RuntimeError, match="CUDA"):
        UsdmPipeline.from_pretrained(missing, missing, missing, missing, missing)


def _lm_batch(vocab, device, t=320, seed=0):
    """One packed row of three BOS-led segments (the window of 64 masks keys
    inside the first) and a shorter padded row."""
    import numpy as np

    from usdm_tpu_torch.data.collators import pack_collate

    rng = np.random.default_rng(seed)
    rows = []
    for n, cuts in ((t, (0, 150, 240)), (t - 40, (0, 100))):
        row = rng.integers(3, vocab, n)
        row[list(cuts)] = 1
        rows.append(row.tolist())
    return {k: torch.from_numpy(v).to(device) for k, v in pack_collate(rows, vocab - 1).items()}


@pytest.mark.cuda
def test_lm_loss_and_grads_on_card_match_cpu(cuda):
    """The LM training path on the card (K2's f32 route forward and in the
    remat recompute, K5's f32 backward, chunked CE) against the CPU's plain
    versions, f32 at tiny widths with head_dim 16, GQA 4/2, packed segments
    and a window that bites: the loss within 1e-5, every gradient within
    1e-4 + 1e-3 rel (3xTF32 ~2^-22 per product, f32 sums in other
    orders)."""
    from usdm_tpu_torch.core.config import MistralConfig
    from usdm_tpu_torch.core.tree import tree_leaves, tree_map
    from usdm_tpu_torch.models import mistral as M

    cfg = MistralConfig.tiny(vocab_size=300).replace(sliding_window=64)
    params = M.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    out = {}
    for dev in ("cpu", cuda):
        p = tree_map(lambda a: a.to(dev).requires_grad_(True), params)
        b = _lm_batch(cfg.vocab_size, dev)
        k2 = FL.flash_attention.launches
        loss, _ = M.loss_fn(p, cfg, b["input_ids"], b["labels"], b["segment_ids"],
                            b["positions"], remat=True, ce_chunk=128)
        grads = torch.autograd.grad(loss, tree_leaves(p))
        out[str(dev)] = (float(loss.detach()), [g.cpu() for g in grads],
                         FL.flash_attention.launches - k2)
    (l_cpu, g_cpu, _), (l_gpu, g_gpu, launched) = out["cpu"], out[str(cuda)]
    assert launched == 2 * cfg.num_layers  # forward and the remat recompute
    assert abs(l_gpu - l_cpu) < 1e-5
    for a, b in zip(g_gpu, g_cpu):
        torch.testing.assert_close(a, b, rtol=1e-3, atol=1e-4)


@pytest.mark.cuda
def test_lm_offload_step_equals_resident_on_card(cuda):
    """make_train_step on an init_offload_state state (moments in one
    registered host buffer, staged leaf by leaf on two side streams) against
    it on an init_state state at bf16 compute over f32 masters: params and
    moments bit for bit over three steps."""
    from usdm_tpu_torch.core.config import MistralConfig, TrainConfig
    from usdm_tpu_torch.core.tree import tree_leaves
    from usdm_tpu_torch.models import mistral as M
    from usdm_tpu_torch.train import lm as T

    cfg = MistralConfig.tiny(vocab_size=300).replace(sliding_window=64, dtype="bfloat16")
    tc = TrainConfig(max_steps=4, learning_rate=1e-3)
    init = M.init_params(cfg, torch.Generator(device=cuda).manual_seed(1), cuda, "float32")
    res = T.init_state(cfg, tc, cuda, params=init)
    off = T.init_offload_state(cfg, tc, cuda, params={k: [dict((n, w.clone()) for n, w in
                                                               lp.items()) for lp in v]
                                                      if k == "layers" else v.clone()
                                                      for k, v in init.items()})
    assert all(t.is_pinned() for t in off.opt_state.m + off.opt_state.v)
    step = T.make_train_step(cfg, tc)
    b = _lm_batch(cfg.vocab_size, cuda, seed=1)
    for _ in range(3):
        assert float(step(res, b)["loss"]) == float(step(off, b)["loss"])
    torch.cuda.synchronize()
    for a, c in zip(tree_leaves(res.params) + res.opt_state.m + res.opt_state.v,
                    tree_leaves(off.params) + off.opt_state.m + off.opt_state.v):
        assert torch.equal(a.detach(), c.detach().to(cuda))


@pytest.mark.cuda
@pytest.mark.parametrize("snakebeta", [False, True])
def test_fused_act_function_grads_match_plain_autograd(cuda, snakebeta):
    """K3's autograd Function on the card at a generator stage shape of
    training (B 4, C 96, T 2048): its forward launches K3 once, within
    K3's bound of the plain version; dx, dalpha and dbeta (None for snake)
    within 1e-5 of each gradient's peak of autograd through
    activation1d_reference (the Function's backward is that recompute);
    the bare launch's output has no grad_fn."""
    x, alpha, beta = _act_case(cuda, (4, 96, 2048), torch.float32, 11)
    x, alpha = x.clone().requires_grad_(), alpha.requires_grad_()
    beta = beta.requires_grad_() if snakebeta else None
    g = torch.randn(x.shape, generator=torch.Generator(device=cuda).manual_seed(2), device=cuda)
    before = FA.fused_activation1d.launches
    y = FA.fused_activation1d(x, alpha, beta, True)
    assert FA.fused_activation1d.launches == before + 1 and y.grad_fn is not None
    want = FA.activation1d_reference(x, alpha, beta, True)
    assert (y - want).abs().max().item() <= _K3_BOUND[torch.float32]
    wrt = [t for t in (x, alpha, beta) if t is not None]
    for got, ref in zip(torch.autograd.grad(y, wrt, g), torch.autograd.grad(want, wrt, g)):
        assert (got - ref).abs().max().item() <= 1e-5 * ref.abs().max().item()
    assert FA._launch(x.detach(), alpha.detach(), None, True).grad_fn is None


@pytest.mark.cuda
@pytest.mark.parametrize("transposed", [False, True])
def test_conv_helper_full_f32_whatever_the_flag(cuda, transposed, monkeypatch):
    """ops/conv.py's conv under cuDNN's TF32 flag on (PyTorch's default):
    forward, dx and dw within 1e-5 of each f64 result's peak; the plain
    F.conv1d / conv_transpose1d call (the helper bypassed) leaves that
    bound (the flag bites, so the check can tell); the flag is restored
    after each call."""
    from usdm_tpu_torch.ops import conv as CV

    gen = torch.Generator(device=cuda).manual_seed(5)
    x = torch.randn(4, 384, 512, generator=gen, device=cuda).requires_grad_()
    w = (torch.randn(384, 384, 7, generator=gen, device=cuda) * 0.05).requires_grad_()
    g = torch.randn(4, 384, 512 * 2 + 5 if transposed else 512, generator=gen, device=cuda)
    kw = dict(stride=2, padding=0, transposed=True) if transposed else dict(padding=3)
    ref = (torch.nn.functional.conv_transpose1d(x.double(), w.double(), stride=2) if transposed
           else torch.nn.functional.conv1d(x.double(), w.double(), padding=3))
    want = torch.autograd.grad(ref, (x, w), g.double())
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    y = CV.conv(x, w, **kw)
    assert torch.backends.cudnn.allow_tf32
    got = torch.autograd.grad(y, (x, w), g)
    assert torch.backends.cudnn.allow_tf32
    for a, b in zip((y,) + got, (ref,) + want):
        assert (a.double() - b).abs().max().item() <= 1e-5 * b.abs().max().item()
    tf32 = (torch.nn.functional.conv_transpose1d(x, w, stride=2) if transposed
            else torch.nn.functional.conv1d(x, w, padding=3))
    assert (tf32.double() - ref).abs().max().item() > 1e-5 * ref.abs().max().item()


@pytest.mark.cuda
def test_gan_steps_on_card_match_cpu(cuda):
    """One disc step and one gen step of the tiny BigVGAN GAN (periods 2
    and 3, one 256-point resolution) on the card and on the CPU from the
    same state and batch: K3 launches 2 x 13 times; every metric within
    1e-4 relative, the params within 2 lr (AdamW's first update is lr * g /
    (|g| + eps), so a gradient near eps moves a weight by up to 2 lr) and
    99 % of them within lr / 100."""
    import numpy as np

    from usdm_tpu_torch.core.config import BigVGANConfig, MelConfig
    from usdm_tpu_torch.core.tree import tree_leaves, tree_map
    from usdm_tpu_torch.data.mel_dataset import loss_mel_config
    from usdm_tpu_torch.train import lm as T
    from usdm_tpu_torch.train import vocoder as V

    cfg = BigVGANConfig.tiny()
    mc = MelConfig().replace(num_mels=cfg.num_mels, n_fft=64, win_size=64,
                             hop_size=cfg.total_upsample)
    rng = np.random.default_rng(0)
    mel = torch.from_numpy((rng.standard_normal((2, cfg.num_mels, 32)) - 5).astype(np.float32))
    wav = torch.from_numpy((rng.standard_normal((2, 1, 32 * cfg.total_upsample)) * 0.1)
                           .astype(np.float32))
    out = {}
    for dev in ("cpu", cuda):
        st, _, _ = V.init_state(cfg, torch.Generator().manual_seed(0), periods=(2, 3))
        st = V.GanTrainState(*(tree_map(lambda t: t.detach().to(dev).requires_grad_(), x)
                               for x in (st.gen_params, st.mpd, st.mrd)),
                             *(T.AdamWState([t.to(dev) for t in o.m], [t.to(dev) for t in o.v])
                               for o in (st.gen_opt, st.disc_opt)))
        ds, gs = V.make_train_steps(cfg, V.make_optimizer(), V.make_optimizer(),
                                    loss_mel_config(mc), ((256, 64, 128),), (2, 3))
        batch = {"mel": mel.to(dev), "wav": wav.to(dev)}
        before = FA.fused_activation1d.launches
        m = {**ds(st, batch), **gs(st, batch)}
        out[str(dev)] = (m, st, FA.fused_activation1d.launches - before)
    (m_cpu, s_cpu, _), (m_gpu, s_gpu, k3) = out["cpu"], out[str(cuda)]
    assert k3 == 2 * 13  # 2 stages x 3 dilations x 2, and the post activation
    for k, v in m_cpu.items():
        assert abs(float(m_gpu[k]) - float(v)) <= 1e-4 * abs(float(v)), k
    diffs = np.concatenate([(a.detach().cpu() - b.detach()).abs().flatten().numpy()
                            for a, b in zip(tree_leaves(s_gpu.params), tree_leaves(s_cpu.params))])
    assert diffs.max() <= 2 * 2e-4 and np.quantile(diffs, 0.99) <= 2e-4 / 100


# ------------------------------------------- the tiny models' head dims (F5)
def _tiny_paged_case(cuda, kind, b):
    """The tiny LM's K1 geometry: GQA 4/2, head_dim 16, page 16, pools of
    two layer regions, shuffled tables, slots of 100 and 7 tokens; bf16 or
    f32 pools and queries, or bf16 queries over int8 pools with page-major
    f32 scales."""
    g = torch.Generator(device=cuda).manual_seed(16 + b)
    hkv, grp, d, page, maxp = 2, 2, 16, 16, 8
    nt = 2 * (b * maxp + 1)
    table = torch.randperm(nt - 1, generator=g, device=cuda)[: b * maxp]
    table = table.reshape(b, maxp).to(torch.int32).contiguous()
    lens = torch.tensor([100, 7][:b], dtype=torch.int32, device=cuda)
    dt = torch.float32 if kind == "f32" else torch.bfloat16
    q = torch.randn(b, hkv, grp, d, generator=g, device=cuda).to(dt)
    if kind != "int8":
        pools = [torch.randn(hkv, nt, page, d, generator=g, device=cuda).to(dt) for _ in range(2)]
        return q, pools, {}, table, lens
    pools, scales = [], []
    for _ in range(2):
        qv, sv = quant_kv_token(torch.randn(hkv, nt, page, d, generator=g, device=cuda))
        pools.append(qv)
        scales.append(sv.transpose(0, 1).contiguous())  # [NT, Hkv, P]
    return q, pools, {"k_scales": scales[0], "v_scales": scales[1]}, table, lens


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["bf16", "f32", "int8"])
@pytest.mark.parametrize("b", [1, 2])
@pytest.mark.parametrize("window", [None, 64])
def test_paged_kernel_head_dim_16(cuda, kind, b, window):
    """K1 at the tiny LM's head_dim 16 against its plain version: bf16 one
    bf16 ulp of the largest output + 1e-4; f32 1e-4; int8 pools that bound
    on f32 queries plus the measured effect of rounding the dequantized K/V
    (as test_paged_int8_kernel_matches_plain states it).  Captured in a
    CUDA graph, the call replays the eager result bit for bit."""
    q, (kp, vp), scales, table, lens = _tiny_paged_case(cuda, kind, b)
    got = PA.paged_decode_attention(q, kp, vp, table, lens, window, **scales)
    want = PA.paged_decode_attention_reference(q, kp, vp, table, lens, window, **scales)
    assert torch.isfinite(got.float()).all()
    err = (got.float() - want.float()).abs().max().item()
    if kind == "f32":
        assert err <= 1e-4
    elif kind == "bf16":
        assert err <= _bf16_bound(want)
    else:
        fold = PA.paged_decode_attention_reference(q.float(), kp, vp, table, lens, window,
                                                   **scales)
        assert err <= _bf16_bound(fold) + (want.float() - fold).abs().max().item()
    graph = torch.cuda.CUDAGraph()
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        PA.paged_decode_attention(q, kp, vp, table, lens, window, **scales)  # warm-up
        with torch.cuda.graph(graph, stream=stream):
            out = PA.paged_decode_attention(q, kp, vp, table, lens, window, **scales)
    torch.cuda.current_stream().wait_stream(stream)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, got)


@pytest.mark.cuda
def test_kernels_raise_on_head_dims_they_do_not_take(cuda):
    """K1 takes multiples of 16 up to 128, K2 and K5 multiples of 8: any
    other head dim raises by name on the card (no plain fallback)."""
    g = torch.Generator(device=cuda).manual_seed(0)
    for d in (8, 24, 144):
        q = torch.randn(1, 2, 2, d, generator=g, device=cuda).bfloat16()
        pool = torch.randn(2, 3, 16, d, generator=g, device=cuda).bfloat16()
        table = torch.zeros(1, 2, dtype=torch.int32, device=cuda)
        lens = torch.ones(1, dtype=torch.int32, device=cuda)
        with pytest.raises(ValueError, match="head_dim"):
            PA.paged_decode_attention(q, pool, pool, table, lens)
    for d in (4, 12, 136):
        x = torch.randn(1, 5, 2, d, generator=g, device=cuda).bfloat16()
        rows = torch.zeros(1, 5, dtype=torch.int32, device=cuda)
        with pytest.raises(ValueError, match="head_dim"):
            FL.flash_attention(x, x, x, rows, rows, rows, rows)


@pytest.mark.cuda
def test_tiny_pipeline_on_card_matches_cpu(cuda, tmp_path):
    """UsdmPipeline.tiny_random's configs unwidened (LM head_dim 16, XLS-R
    and Voicebox 8) on the card against the CPU, as chip_smoke's phase 13
    runs it: the same dialog tokens, K1-K3 launched, the wavs within 1e-3
    of the peak from shared noise, also past the estimator's flash gate."""
    import numpy as np

    import chip_smoke
    from usdm_tpu_torch.audio.wav import write_wav
    from usdm_tpu_torch.pipeline import UsdmPipeline

    wav = str(tmp_path / "user.wav")
    write_wav(wav, (np.random.default_rng(0).standard_normal(48000) * 0.1).astype(np.float32),
              16000)
    _, got, counts = chip_smoke.turn_on_card_check(cuda, wav, UsdmPipeline.tiny_random(
        device="cpu"), "tiny", long_units=100)
    assert got["agent_units"] and all(counts.values())


@pytest.mark.cuda
def test_tiny_clis_on_card(cuda, tmp_path):
    """The tiny entry points in subprocesses on the card: cli.infer --demo
    writes a wav, cli.serve --demo answers one POST, cli.train_voicebox
    --tiny (bf16 over f32 masters: K2 and K5 at head_dim 8) and
    cli.train_pt --tiny (K2 and K5 at 16) take two steps."""
    import numpy as np

    import chip_smoke
    from usdm_tpu_torch.audio.wav import write_wav

    rng = np.random.default_rng(0)
    wav = str(tmp_path / "user.wav")
    write_wav(wav, (rng.standard_normal(48000) * 0.1).astype(np.float32), 16000)
    chip_smoke.run_module("usdm_tpu_torch.cli.infer", "--demo", "--input_path", wav,
                          "--output_path", str(tmp_path / "out.wav"), "--n_timesteps", "4")
    assert (tmp_path / "out.wav").stat().st_size > 44
    assert chip_smoke.serve_demo_post(wav)["audio_b64"]
    lines = []
    for i in range(4):
        path = str(tmp_path / f"clip{i}.wav")
        n = int(22050 * rng.uniform(1.0, 2.0))
        write_wav(path, (rng.standard_normal(n) * 0.1).astype(np.float32), 22050)
        units = rng.integers(0, 32, -(-n // 441)).tolist()
        lines.append(f"{path}|{' '.join(map(str, units))}|{' '.join('1' for _ in units)}")
    (tmp_path / "list.txt").write_text("\n".join(lines))
    chip_smoke.run_module("usdm_tpu_torch.cli.train_voicebox", "--tiny", "--train_filelist",
                          str(tmp_path / "list.txt"), "--output_dir", str(tmp_path / "vb"),
                          "--batch_size", "2", "--max_steps", "2", "--out_size_second", "2")
    rows = tmp_path / "rows"
    rows.mkdir()
    (rows / "part0.txt").write_text("\n".join(" ".join(map(str, rng.integers(3, 500, 200)))
                                              for _ in range(4)))
    chip_smoke.run_module("usdm_tpu_torch.cli.train_pt", "--tiny", "--data_path", str(rows),
                          "--output_dir", str(tmp_path / "pt"), "--max_steps", "2",
                          "--max_input_length", "256", "--save_steps", "0")


# ------------------------------------------- the measuring scripts' shapes
@pytest.mark.cuda
@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_paged_kernel_batch32_page256(cuda, kv):
    """K1 at bench_batch_decode's b 32: page 256, 6 pages a slot, 1,220
    tokens a slot (one slot 700), window 4096, at the host's split count.
    Bounds as test_paged_kernel_matches_plain (bf16 pools) and
    test_paged_int8_kernel_matches_plain (int8 pools)."""
    g = torch.Generator(device=cuda).manual_seed(32)
    b, hkv, grp, d, page, maxp = 32, 8, 4, 128, 256, 6
    nt = b * maxp + 1
    table = torch.randperm(nt - 1, generator=g, device=cuda)[: b * maxp]
    table = table.reshape(b, maxp).to(torch.int32).contiguous()
    lens = torch.full((b,), 1220, dtype=torch.int32, device=cuda)
    lens[5] = 700
    q = torch.randn(b, hkv, grp, d, generator=g, device=cuda).bfloat16()
    scales = {}
    if kv == "bf16":
        pools = [torch.randn(hkv, nt, page, d, generator=g, device=cuda).bfloat16()
                 for _ in range(2)]
    else:
        pools = []
        for key in ("k_scales", "v_scales"):
            qv, sv = quant_kv_token(torch.randn(hkv, nt, page, d, generator=g, device=cuda))
            pools.append(qv)
            scales[key] = sv.transpose(0, 1).contiguous()
    got = PA.paged_decode_attention(q, *pools, table, lens, 4096, **scales)
    want = PA.paged_decode_attention_reference(q, *pools, table, lens, 4096, **scales)
    assert torch.isfinite(got.float()).all()
    if kv == "bf16":
        assert (got.float() - want.float()).abs().max().item() <= _bf16_bound(want)
    else:
        fold = PA.paged_decode_attention_reference(q.float(), *pools, table, lens, 4096,
                                                   **scales)
        rounding = (want.float() - fold).abs().max().item()
        assert (got.float() - fold).abs().max().item() <= _bf16_bound(fold)
        assert (got.float() - want.float()).abs().max().item() <= _bf16_bound(fold) + rounding


@pytest.mark.cuda
@pytest.mark.parametrize("dout", [6144, 28672, 42003])
def test_stream_qmv_fused_and_head_widths(cuda, dout):
    """K6 at M 1 at exp_decode2's widths: the fused qkv (6,144) and gate|up
    (28,672) products and the W8A8 lm_head's 42,003 (odd) rows, Din 4096:
    f32 bit for bit, bf16 within one ulp of each value."""
    y, w = _qmv_case(cuda, 1, dout, 4096)
    _assert_qmv_exact(y, w)


@pytest.mark.cuda
@pytest.mark.parametrize("fused,unfused", [("fused", "full"), ("fused_nohead", "no_head"),
                                           ("fused_int8head", "head_int8")])
def test_fused_w8a8_step_variant_tokens(cuda, fused, unfused):
    """exp_decode2's fused W8A8 variants give the unfused ones' tokens on
    the card (each output row's integer product is exact whatever Dout the
    product has), over a small random W8A8 model (bf16, head_dim 16, lm_head
    scaled up for peaked logits), 3 slots over a seeded pool; the step
    launches K6 and K1."""
    from usdm_tpu_torch.core.config import MistralConfig
    from usdm_tpu_torch.engine.paged_ops import PagedKV
    from usdm_tpu_torch.models import mistral as M
    from usdm_tpu_torch.scripts import exp_decode2 as ED2

    cfg = MistralConfig.tiny().replace(dtype="bfloat16", head_dim=16)
    g = torch.Generator(device=cuda).manual_seed(5)
    params = M.init_params(cfg, g, cuda)
    params["lm_head"] = params["lm_head"] * 8.0
    fused_params = ED2.fuse_weights(Q.quantize_llm_params(params))
    b, page, maxp = 3, 16, 4
    n_pages = b * maxp + 1
    kv = PagedKV.create(cfg, n_pages, page, cuda)
    kv.k_pages.normal_(generator=g)
    kv.v_pages.normal_(generator=g)
    table = torch.randperm(n_pages - 1, generator=g, device=cuda)[: b * maxp]
    table = table.reshape(b, maxp).to(torch.int32).contiguous()
    args = (kv, cfg, torch.tensor([5, 40, 200], device=cuda),
            torch.tensor([13, 40, 61], dtype=torch.int32, device=cuda), table,
            torch.ones(b, dtype=torch.bool, device=cuda),
            torch.ones(b, cfg.vocab_size, dtype=torch.bool, device=cuda), page)
    k6, k1 = SM.stream_qmv.launches, PA.paged_decode_attention.launches
    want = ED2.step_variant(fused_params, *args, **ED2.VARIANTS[unfused])
    got = ED2.step_variant(fused_params, *args, **ED2.VARIANTS[fused])
    assert torch.equal(got, want)
    assert SM.stream_qmv.launches - k6 == 11 * cfg.num_layers + 2 * (fused == "fused_int8head")
    assert PA.paged_decode_attention.launches - k1 == 2 * cfg.num_layers
