"""The least-time bounds that ``chip_smoke.py`` writes beside each kernel.

No card is needed: the SASS below is the loop of ``bernoulli_kernel`` as
``cuobjdump -sass`` prints it for ``csrc/bernoulli.cu`` built for sm_90a
(CUDA 12.8), and the card's rates are replaced by an H100's (132 SMs at
1,980 MHz).  Every check is exact arithmetic or an exact count.
"""
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

# one intra-op thread: the tier-1 run's six pytest-xdist workers would
# otherwise start a thread a core each and oversubscribe the CPU
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location("chip_smoke",
                                               ROOT / "chip_smoke.py")
smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(smoke)

BERNOULLI_SASS = """\
        code for sm_90a
        Function : _ZN45_GLOBAL__N__7f25ec60_12_bernoulli_cu_5affc2d216bernoulli_kernelEPKfPKlllPh
/*0150*/ LDG.E.CONSTANT R0, desc[UR6][R12.64] ;
/*0160*/ IMAD.MOV.U32 R10, RZ, RZ, RZ ;
/*0170*/ IMAD.U32 R9, RZ, RZ, UR4 ;
/*0180*/ ULDC.64 UR4, c[0x0][0x230] ;
/*0190*/ LEA R12, P0, R9, R6, 0x3 ;
/*01a0*/ LEA.HI.X R13, R9, R7, R10, 0x3, P0 ;
/*01b0*/ LDG.E.CONSTANT R13, desc[UR6][R12.64] ;
/*01c0*/ IMAD R11, R2, -0x61c88647, R13 ;
/*01d0*/ SHF.R.U32.HI R14, RZ, 0x10, R11 ;
/*01e0*/ LOP3.LUT R14, R14, R11, RZ, 0x3c, !PT ;
/*01f0*/ IMAD R14, R14, -0x7a143595, RZ ;
/*0200*/ SHF.R.U32.HI R11, RZ, 0xd, R14 ;
/*0210*/ LOP3.LUT R11, R11, R14, RZ, 0x3c, !PT ;
/*0220*/ IMAD R11, R11, -0x3d4d51cb, RZ ;
/*0230*/ SHF.R.U32.HI R14, RZ, 0x10, R11.reuse ;
/*0240*/ LOP3.LUT R15, R11, 0x9e3779b9, RZ, 0x3c, !PT ;
/*0250*/ LOP3.LUT R14, R14, 0x9e3779b9, R11, 0x96, !PT ;
/*0260*/ SHF.R.U32.HI R15, RZ, 0x10, R15 ;
/*0270*/ LOP3.LUT R14, R15, R14, RZ, 0x3c, !PT ;
/*0280*/ IMAD R14, R14, -0x7a143595, RZ ;
/*0290*/ SHF.R.U32.HI R11, RZ, 0xd, R14 ;
/*02a0*/ LOP3.LUT R11, R11, R14, RZ, 0x3c, !PT ;
/*02b0*/ IMAD R14, R10, UR8, RZ ;
/*02c0*/ IMAD R11, R11, -0x3d4d51cb, RZ ;
/*02d0*/ IMAD R15, R9, UR9, R14 ;
/*02e0*/ SHF.R.U32.HI R12, RZ, 0x10, R11 ;
/*02f0*/ LOP3.LUT R12, R12, R11, RZ, 0x3c, !PT ;
/*0300*/ I2FP.F32.U32 R11, R12 ;
/*0310*/ IMAD.WIDE.U32 R12, R9, UR8, R2 ;
/*0320*/ FMUL R11, R11, 2.3283064365386962891e-10 ;
/*0330*/ IADD3 R12, P1, R12, UR4, RZ ;
/*0340*/ FSETP.GEU.AND P0, PT, R11, R0, PT ;
/*0350*/ IADD3.X R13, R13, UR5, R15, P1, !PT ;
/*0360*/ SEL R11, RZ, 0x1, P0 ;
/*0370*/ IADD3 R9, P0, R8, R9, RZ ;
/*0380*/ STG.E.U8 desc[UR6][R12.64], R11 ;
/*0390*/ IMAD.X R10, RZ, RZ, R10, P0 ;
/*03a0*/ ISETP.GE.U32.AND P0, PT, R9, R4, PT ;
/*03b0*/ ISETP.GE.AND.EX P0, PT, R10, R5, PT, P0 ;
/*03c0*/ @!P0 BRA 0x190 ;
/*03d0*/ EXIT ;
/*03e0*/ BRA 0x3e0;
"""

H100_MHZ, H100_SMS = 1980.0, 132


@pytest.fixture
def h100(monkeypatch):
    monkeypatch.setattr(smoke, "card_rates", lambda: {
        "clocks_max_sm_mhz": H100_MHZ,
        "ops_s": {k: H100_SMS * v * H100_MHZ * 1e6
                  for k, v in smoke.PER_SM_CLOCK.items()}})


def test_sass_slice_counts_the_trial_not_its_addressing():
    # the hash: 6 shifts, 7 LOP3s and the select on the ALU; the counter
    # multiply-add and 4 hash multiplies as IMADs; the scale and the compare
    # in float32; the conversion.  The LEA/IADD3/IMAD.WIDE address and loop
    # arithmetic and the seed load are left out.
    assert smoke.sass_ops_per_store(BERNOULLI_SASS, "bernoulli_kernel") == {
        "alu": 14.0, "imad": 5.0, "fp32": 2.0, "xu": 1.0}


def test_sass_slice_per_store_in_an_unrolled_loop():
    sass = """Function : kern
/*0000*/ LDG.E R2, desc[UR4][R6.64] ;
/*0010*/ LOP3.LUT R3, R2, 0x1, RZ, 0xc0, !PT ;
/*0020*/ SHF.R.U32.HI R4, RZ, 0x1, R2 ;
/*0030*/ STG.E.U8 desc[UR4][R8.64], R3 ;
/*0040*/ LOP3.LUT R4, R4, 0x1, RZ, 0xc0, !PT ;
/*0050*/ IADD3 R6, P0, R6, 0x4, RZ ;
/*0060*/ STG.E.U8 desc[UR4][R8.64+0x1], R4 ;
/*0070*/ @P1 BRA 0x0 ;
"""
    # three ALU instructions feed two stores; the pointer bump feeds none
    assert smoke.sass_ops_per_store(sass, "kern") == {"alu": 1.5}


def test_sass_slice_raises_on_an_unclassed_instruction():
    sass = """Function : kern
/*0000*/ LDG.E R2, desc[UR4][R6.64] ;
/*0010*/ HMUL2 R3, R2, R2 ;
/*0020*/ STG.E.U8 desc[UR4][R8.64], R3 ;
/*0030*/ @P1 BRA 0x0 ;
"""
    with pytest.raises(ValueError, match="HMUL2"):
        smoke.sass_ops_per_store(sass, "kern")


# the word-store loop of the redesigned trial kernel, cut to one group of
# four trials a row: four hashes' last steps, four threshold compares
# packed into a word, masked by the live edges, one 4-byte store
WORD_STORE_SASS = """\
        Function : _ZN45_GLOBAL__N__bernoulli_cu16bernoulli_kernelILb1EEEvPKfPKlllPh
/*0100*/ LDG.E.64.CONSTANT R2, desc[UR6][R20.64] ;
/*0110*/ IADD3 R4, R8, R2, RZ ;
/*0120*/ IADD3 R5, R9, R2, RZ ;
/*0130*/ IADD3 R6, R10, R2, RZ ;
/*0140*/ IADD3 R7, R11, R2, RZ ;
/*0150*/ IMAD R4, R4, -0x7a143595, RZ ;
/*0160*/ IMAD R5, R5, -0x7a143595, RZ ;
/*0170*/ IMAD R6, R6, -0x7a143595, RZ ;
/*0180*/ IMAD R7, R7, -0x7a143595, RZ ;
/*0190*/ ISETP.GT.U32.AND P0, PT, R4, R12, PT ;
/*01a0*/ ISETP.GT.U32.AND P1, PT, R5, R13, PT ;
/*01b0*/ ISETP.GT.U32.AND P2, PT, R6, R14, PT ;
/*01c0*/ ISETP.GT.U32.AND P3, PT, R7, R15, PT ;
/*01d0*/ SEL R4, RZ, 0x1, P0 ;
/*01e0*/ SEL R5, RZ, 0x100, P1 ;
/*01f0*/ SEL R6, RZ, 0x10000, P2 ;
/*0200*/ SEL R7, RZ, 0x1000000, P3 ;
/*0210*/ LOP3.LUT R4, R4, R5, R6, 0xfe, !PT ;
/*0220*/ LOP3.LUT R4, R4, R7, R16, 0xe0, !PT ;
/*0230*/ IMAD.WIDE.U32 R20, R17, 0x8, R20 ;
/*0240*/ @!P4 STG.E desc[UR6][R18.64], R4 ;
/*0250*/ IADD3 R18, P5, R18, R22, RZ ;
/*0260*/ ISETP.GE.U32.AND P6, PT, R18, R23, PT ;
/*0270*/ @!P6 BRA 0x100 ;
/*0280*/ EXIT ;
"""


def test_sass_slice_counts_per_trial_of_a_word_store():
    # 4 IADD3 + 4 ISETP + 4 SEL + 2 LOP3 on the ALU and 4 IMADs feed one
    # 4-byte store: 4 trials.  The seed load, the seed pointer's IMAD.WIDE,
    # the row pointer and the loop test are not counted.
    assert smoke.sass_ops_per_store(WORD_STORE_SASS, "kernelILb1E") == {
        "alu": 14 / 4, "imad": 1.0}


def test_sass_slice_counts_the_lanes_of_a_16_byte_store():
    """STG.E.128 stores R4..R7: all four registers' slices are counted, and
    the store stands for 16 trials; STG.E.64 for 8 (R8, R9)."""
    sass = """Function : kern
/*0000*/ LDG.E R2, desc[UR4][R10.64] ;
/*0010*/ LOP3.LUT R4, R2, 0x1, RZ, 0xc0, !PT ;
/*0020*/ LOP3.LUT R5, R2, 0x2, RZ, 0xc0, !PT ;
/*0030*/ LOP3.LUT R6, R2, 0x4, RZ, 0xc0, !PT ;
/*0040*/ IMAD R7, R2, 0x3, RZ ;
/*0050*/ SHF.R.U32.HI R8, RZ, 0x1, R2 ;
/*0060*/ SHF.R.U32.HI R9, RZ, 0x2, R2 ;
/*0070*/ STG.E.128 desc[UR4][R12.64], R4 ;
/*0080*/ STG.E.64 desc[UR4][R12.64+0x10], R8 ;
/*0090*/ IADD3 R12, P0, R12, 0x18, RZ ;
/*00a0*/ @P1 BRA 0x0 ;
"""
    assert smoke.sass_ops_per_store(sass, "kern") == {"alu": 5 / 24,
                                                      "imad": 1 / 24}
    assert [smoke.store_bytes(op) for op in (
        "STG.E.U8", "STG.E", "STG.E.64", "STG.E.128", "STG.E.U16",
        "STG.E.STRONG.GPU", "LDG.E.128", "STS.128")] == \
        [1, 4, 8, 16, 2, 4, 0, 0]


def test_sass_slice_raises_without_a_store_in_a_loop():
    sass = """Function : kern
/*0000*/ LDG.E R2, desc[UR4][R6.64] ;
/*0010*/ STG.E desc[UR4][R8.64], R2 ;
/*0020*/ EXIT ;
"""
    with pytest.raises(ValueError, match="no global store"):
        smoke.sass_ops_per_store(sass, "kern")


def test_trial_bound_is_the_smaller_of_the_two_counts(h100):
    """The record's bound is the lesser of the built loop's own count and
    the float-compare loop's count of the work: a leaner loop (fewer ALU
    instructions) sets it, and a loop with more (its packing) does not
    raise it."""
    import torch
    w, seeds = torch.zeros(607012), torch.zeros(512, dtype=torch.int64)
    trials = 512 * 607012
    alu_s = H100_SMS * 64 * H100_MHZ * 1e6
    work_ms = 14 * trials / alu_s * 1e3
    assert smoke.TRIAL_WORK_OPS == {"alu": 14, "imad": 5, "fp32": 2, "xu": 1}
    heavier = smoke.trial_bound(w, seeds, {"alu": 16.5, "imad": 5.0})
    assert heavier["bound_from"] == "work"
    assert heavier["bound_ms"] == pytest.approx(work_ms)
    assert 0.2600 < heavier["bound_ms"] < 0.2602
    assert heavier["bound_own_ms"] == pytest.approx(16.5 / 14 * work_ms)
    leaner = smoke.trial_bound(w, seeds, {"alu": 12.0, "imad": 11.0})
    assert leaner["bound_from"] == "own"
    assert leaner["bound_ms"] == pytest.approx(12 / 14 * work_ms)
    assert leaner["bound_work_ms"] == pytest.approx(work_ms)
    assert leaner["trial_ops_own"] == {"alu": 12.0, "imad": 11.0}
    assert leaner["bound_by"] == "operations"


def test_occur_bound_is_the_bytes_at_the_exact_path(h100):
    # (16,384 x 2,372) words: reading them is 0.0465 ms at 3.35 TB/s; a
    # positional popcount's two LOP3s a word take a tenth of that
    b = smoke.bound_ms(16384, 16384, 2372, masked=False)
    assert b["bound_by"] == "bytes"
    assert b["bound_ms"] == b["bound_bytes_ms"] == pytest.approx(
        (16384 * 2372 * 4 + 2372 * 128) / 3.35e9)
    assert b["bound_ops_ms"] < b["bound_bytes_ms"] / 5
    m = smoke.bound_ms(2469, 16384, 2372, masked=True)
    assert m["bound_by"] == "bytes"
    assert m["bound_ms"] == pytest.approx(
        (2469 * 2372 * 4 + 2372 * 128 + 16384 * 4) / 3.35e9)


def test_trial_bound_is_the_alu_at_each_class_rate(h100):
    ops = {"alu": 14.0, "imad": 5.0, "fp32": 2.0, "xu": 1.0}
    trials = 512 * 607012
    b = smoke._bound(4 * 607012 + 8 * 512 + trials,
                     {k: v * trials for k, v in ops.items()})
    alu_s = H100_SMS * 64 * H100_MHZ * 1e6
    assert (b["bound_by"], b["bound_ops_class"]) == ("operations", "alu")
    assert b["bound_ms"] == pytest.approx(14 * trials / alu_s * 1e3)
    # every class alone, and all at the dispatch rate, would take less
    dispatch_ms = 22 * trials / (2 * alu_s) * 1e3
    assert dispatch_ms < b["bound_ms"]
    assert b["bound_bytes_ms"] < b["bound_ms"]


def test_membership_bound_counts_the_sectors_of_valid_prefixes(h100):
    import torch
    # rows of 128 int32 (512 bytes, sector-aligned): lengths 0, 1, 8, 9 and
    # 128 touch 0, 1, 1, 2 and 16 sectors; a length past L counts as L and
    # a negative one as 0
    lens = torch.tensor([0, 1, 8, 9, 128, 300, -4])
    b = smoke.membership_bound_ms(lens, 128)
    nbytes = 32 * (0 + 1 + 1 + 2 + 16 + 16 + 0) + 4 * 7 + 4 + 7
    assert b["bound_by"] == "bytes"
    assert b["bound_ms"] == b["bound_bytes_ms"] == pytest.approx(
        nbytes / 3.35e9)
    # rows of 3 int32 (12 bytes) straddle sectors: row 2 spans bytes 24-35
    b = smoke.membership_bound_ms(torch.tensor([3, 3, 3]), 3)
    assert b["bound_bytes_ms"] == pytest.approx((32 * 4 + 12 + 4 + 3) / 3.35e9)


def test_padded_greedy_bound_counts_the_prefixes_once_and_k_scans(h100):
    """The valid prefixes' sectors and the lengths read once, 2k + 1
    outputs written; k compares a valid lane: at k = 50 on rows of 128
    lanes the compares (on the ALU) outweigh the bytes."""
    import torch
    lens = torch.tensor([0, 1, 8, 9, 128, 300, -4])
    b = smoke.padded_greedy_bound(lens, 128, 50)
    sectors, lanes = 0 + 1 + 1 + 2 + 16 + 16 + 0, 1 + 8 + 9 + 128 + 128
    assert (b["prefix_sectors"], b["valid_lanes"]) == (sectors, lanes)
    assert b["bound_bytes_ms"] == pytest.approx(
        (32 * sectors + 4 * 7 + 4 * 101) / 3.35e9)
    alu_s = H100_SMS * 64 * H100_MHZ * 1e6
    assert b["bound_ops_class"] == "alu"
    assert b["bound_ops_ms"] == pytest.approx(50 * lanes / alu_s * 1e3)
    one = smoke.padded_greedy_bound(lens, 128, 1)
    assert one["bound_by"] == "bytes" and b["bound_by"] == "operations"


def test_padded_greedy_bound_at_the_exact_cell(h100):
    """8,704 rows of 128 lanes, 35,538 valid, k = 50: the 1.78 million
    compares bound it at about 0.1 us, far below its barrier floor."""
    import torch
    rng = np.random.default_rng(0)
    lens = torch.tensor(rng.multinomial(35_538 - 8_704, np.ones(8_704)
                                        / 8_704) + 1)
    b = smoke.padded_greedy_bound(lens, 128, 50)
    assert b["valid_lanes"] == 35_538
    assert b["bound_by"] == "operations"
    assert b["bound_ms"] == pytest.approx(50 * 35_538 / (
        H100_SMS * 64 * H100_MHZ * 1e6) * 1e3)


def test_fold_bound_counts_valid_lanes_and_distinct_sectors(h100):
    """Rows 0 and 2 hold lanes (row 1 is empty, row 3 past W counts W);
    row ids 7, 8, 9 (row 1 takes none) bucket mod 64 into words 0 and 1;
    node 9 lies past R = 6 and adds no sector.  Sectors of 8 words: node
    v's word w is word 2v + w of the matrix."""
    import torch
    words = torch.zeros(6, 2, dtype=torch.int32)
    nodes = torch.tensor([[1, 2, 9], [0, 0, 0], [5, 5, 0], [3, 4, 1]])
    lens = torch.tensor([2, 0, 1, 8])
    b = smoke.fold_bound_ms(words, nodes, lens, 7, k=64, mode="mod")
    assert b["valid_lanes"] == 2 + 0 + 1 + 3
    # buckets: row 0 -> 7 (word 0), row 2 -> 8 (word 0), row 3 -> 9;
    # words 2, 4, 10, 6, 8, 2 -> sectors 0 and 1
    assert b["word_sectors"] == 2
    assert b["bound_bytes_ms"] == pytest.approx(
        (4 * 4 + 4 * 6 + 64 * 2 + 16) / 3.35e9)
    assert b["bound_by"] == "bytes"


def test_fold_bound_reads_the_batch_as_the_kernel_does(h100):
    """A strided view of a wider queue gives the bound of its contiguous
    copy, and the sectors are the scatter's over the same pairs."""
    import torch
    from repro_torch.kernels import sketch as tks
    rng = np.random.default_rng(3)
    queue = torch.tensor(rng.integers(0, 90, (64, 20)).astype(np.int32))
    nodes, lens = queue[:, :9], torch.tensor(rng.integers(-1, 12, 64))
    words = torch.zeros(80, 4, dtype=torch.int32)
    for mode in ("mod", "mix"):
        got = smoke.fold_bound_ms(words, nodes, lens, 2 ** 32 - 3, k=128,
                                  mode=mode)
        assert got == smoke.fold_bound_ms(words, nodes.contiguous(), lens,
                                          2 ** 32 - 3, k=128, mode=mode)
        v, b = tks.frontier_pairs(nodes, lens, tks.canonical_row_ids(
            lens, 2 ** 32 - 3), n_rows=80, k=128, mode=mode)
        pairs = smoke.scatter_bound_ms(words, v, b)
        sectors = (pairs["bound_bytes_ms"] * 3.35e9 - 8 * v.numel()) / 64
        assert got["word_sectors"] == pytest.approx(sectors)
        assert got["valid_lanes"] == int(lens.clamp(0, 9).sum())


@pytest.mark.parametrize("shape,causal,pairs", [
    ((2, 2048, 16, 128), True, 2048 * 2049 // 2),
    ((1, 4096, 14, 64), False, 4096 * 4096),
    ((1, 1024, 16, 256), True, 1024 * 1025 // 2),
    ((2, 16, 3, 8), True, 136),
    ((1, 4096, 14, 64), True, 4096 * 4097 // 2),
], ids=["olmo-1b", "qwen2-0.5b", "gemma3-12b", "tiny", "qwen2-0.5b-causal"])
def test_flash_work_counts(shape, causal, pairs):
    b, s, h, d = shape
    w = smoke.flash_work(b, s, h, d, causal)
    assert w == {"pairs": pairs, "flops": 4 * b * h * d * pairs,
                 "exps": b * h * pairs}


def test_flash_bound_at_olmo_is_the_tensor_cores(h100):
    import torch
    b = smoke.flash_bound_ms(2, 2048, 16, 128, torch.bfloat16, True)
    flops = 34_376_515_584                  # 4 * 2 * 16 * 128 * 2,098,176
    assert smoke.flash_work(2, 2048, 16, 128, True)["flops"] == flops
    assert (b["bound_by"], b["bound_ops_class"]) == ("operations", "tensor16")
    assert b["bound_ms"] == pytest.approx(
        flops / (H100_SMS * 4096 * H100_MHZ * 1e6) * 1e3)
    assert 0.0320 < b["bound_ms"] < 0.0325
    # 2 * 2048 * 16 * 128 * 2 bytes, four times; the tensor-core flops are
    # not counted against the dispatch rate
    assert b["bound_bytes_ms"] == pytest.approx(4 * 2 * 2048 * 16 * 128 * 2
                                                / 3.35e9)
    exps = 2 * 16 * 2_098_176
    assert b["bound_ops_ms"] > exps / (H100_SMS * 16 * H100_MHZ * 1e6) * 1e3


def test_flash_bound_in_float32_is_the_fma_pipe(h100):
    import torch
    w = smoke.flash_work(1, 4096, 14, 64, False)
    b = smoke.flash_bound_ms(1, 4096, 14, 64, torch.float32, False)
    per_s = H100_SMS * 128 * H100_MHZ * 1e6
    assert b["bound_by"] == "operations"
    # the FMAs and the exponentials all pass the dispatch rate
    assert b["bound_ms"] == pytest.approx(
        (w["flops"] // 2 + w["exps"]) / per_s * 1e3)
    assert b["bound_ms"] > w["flops"] / 2 / per_s * 1e3
    assert b["bound_bytes_ms"] == pytest.approx(4 * 4096 * 14 * 64 * 4
                                                / 3.35e9)


def test_flash_bound_at_qwen_bf16_causal_ties_tensor_cores_and_exps(h100):
    """D = 64 is where 4*D = 256 equals the tensor rate over the
    exponential rate (4,096 / 16 a clock per SM): both sides 0.0281 ms."""
    import torch
    w = smoke.flash_work(1, 4096, 14, 64, True)
    assert w["pairs"] == 8_390_656
    b = smoke.flash_bound_ms(1, 4096, 14, 64, torch.bfloat16, True)
    tensor = w["flops"] / (H100_SMS * 4096 * H100_MHZ * 1e6) * 1e3
    exps = w["exps"] / (H100_SMS * 16 * H100_MHZ * 1e6) * 1e3
    assert tensor == pytest.approx(exps)
    assert 0.0280 < tensor < 0.0282
    assert b["bound_by"] == "operations"
    assert b["bound_ms"] == pytest.approx(tensor)
    assert b["bound_ops_class"] in ("tensor16", "xu")
    assert b["bound_bytes_ms"] == pytest.approx(4 * 4096 * 14 * 64 * 2
                                                / 3.35e9)


def test_flash_bound_in_float16_equals_bfloat16(h100):
    import torch
    half = smoke.flash_bound_ms(2, 2048, 16, 128, torch.float16, True)
    assert half == smoke.flash_bound_ms(2, 2048, 16, 128, torch.bfloat16,
                                        True)
    assert (half["bound_by"], half["bound_ops_class"]) == ("operations",
                                                           "tensor16")
    assert 0.0320 < half["bound_ms"] < 0.0325


_MANGLED_TYPE = {"float32": "f", "bfloat16": "13__nv_bfloat16",
                 "float16": "6__half"}


def _flash_name(kind, dtype, d, causal):
    args = ("14CUtensorMap_stS2_S2_PT_iifi" if kind == "wgmma"
            else "PKT_S4_S4_PS2_llfl")
    return (f"_ZN45_GLOBAL__N__2deea39f_12_flashattn_cu_ddac23b6"
            f"{len(kind) + 13}flash_{kind}_kernelI{_MANGLED_TYPE[dtype]}"
            f"Li{d}ELb{int(causal)}EEEv{args}")


def _flash_build(drop_op=None, spill=None, extra=None, skip=None):
    """SASS and ptxas text of the 36 kernels that design() routes to (the
    split kernel's D is its 256-column slice)."""
    sass, ptxas = ["        code for sm_90a"], []
    for dtype in ("float32", "bfloat16", "float16"):
        for width in (8, 16, 64, 128, 256, "split"):
            for causal in (False, True):
                kind = ("simt_split" if width == "split" else
                        "wgmma" if dtype != "float32" and width >= 64
                        else "simt")
                d = 256 if width == "split" else width
                name = _flash_name(kind, dtype, d, causal)
                if name == skip:
                    continue
                body = ["/*0010*/ FFMA R1, R2, R3, R1 ;",
                        "/*0020*/ LDS.128 R4, [R5] ;"]
                if kind == "wgmma":
                    body = ["/*0010*/ UTMALDG.4D [UR8], [UR4] ;",
                            "/*0020*/ HGMMA.64x128x16.F32.BF16 R24, "
                            "gdesc[UR8], RZ, !UPT ;",
                            "/*0030*/ HGMMA.64x128x16.F32.BF16 R24, "
                            "R120, gdesc[UR12], R24 ;"]
                    body = [x for x in body if drop_op is None
                            or not (name == drop_op[0] and drop_op[1] in x)]
                sass.append(f"        Function : {name}")
                sass += body
                stores = spill[1] if spill and spill[0] == name else 0
                ptxas.append(f"ptxas info    : Function properties for "
                             f"{name}\n    {8 * stores} bytes stack frame, "
                             f"{stores} bytes spill stores, {stores} bytes "
                             f"spill loads")
    if extra:
        sass.append(f"        Function : {extra}")
        sass.append("/*0010*/ FFMA R1, R2, R3, R1 ;")
    return "\n".join(sass), "\n".join(ptxas)


def test_flash_sass_check_counts_every_kernel():
    counts = smoke.flash_sass_check(*_flash_build())
    assert len(counts) == 36
    assert counts["simt_split/float32/256/causal"]["FFMA"] == 1
    assert "simt_split/bfloat16/256/full" in counts
    wg = counts["wgmma/bfloat16/256/causal"]
    assert (wg["HGMMA"], wg["UTMALDG"]) == (2, 1)
    assert counts["simt/float32/64/full"] == {"HGMMA": 0, "UTMALDG": 0,
                                              "FFMA": 1, "LDS": 1}
    assert "simt/bfloat16/16/causal" in counts


@pytest.mark.parametrize("case", ["no-hgmma", "no-utmaldg", "spill",
                                  "wrong-route", "missing", "split-spill",
                                  "split-missing", "split-width"])
def test_flash_sass_check_raises(case):
    name = _flash_name("wgmma", "float16", 128, True)
    split = _flash_name("simt_split", "bfloat16", 256, False)
    kw = {"no-hgmma": {"drop_op": (name, "HGMMA")},
          "no-utmaldg": {"drop_op": (name, "UTMALDG")},
          "spill": {"spill": (_flash_name("simt", "float32", 64, False), 4)},
          "wrong-route": {"extra": _flash_name("simt", "bfloat16", 64,
                                               True)},
          "missing": {"skip": name},
          "split-spill": {"spill": (split, 8)},
          "split-missing": {"skip": split},
          "split-width": {"extra": _flash_name("simt_split", "float32", 128,
                                               True)}}[case]
    with pytest.raises(AssertionError):
        smoke.flash_sass_check(*_flash_build(**kw))


# the Occur kernels as `-Xptxas -v` reports them for csrc/occur.cu
OCCUR_PTXAS = """\
ptxas info    : Compiling entry function '_ZN40_GLOBAL__N__c50b1140_8_occur_cu_beab49e419occur_masked_kernelIiEEvPKjPKT_llliPi' for 'sm_90a'
ptxas info    : Function properties for _ZN40_GLOBAL__N__c50b1140_8_occur_cu_beab49e419occur_masked_kernelIiEEvPKjPKT_llliPi
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 48 registers, used 1 barriers, 17920 bytes smem
ptxas info    : Function properties for _ZN40_GLOBAL__N__c50b1140_8_occur_cu_beab49e419occur_masked_kernelIhEEvPKjPKT_llliPi
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Function properties for _ZN40_GLOBAL__N__c50b1140_8_occur_cu_beab49e412occur_kernelEPKjllliPi
    8 bytes stack frame, 8 bytes spill stores, 8 bytes spill loads
"""


def test_ptxas_spills_reads_each_kernel():
    spills = smoke.ptxas_spills(OCCUR_PTXAS, "occur_")
    assert len(spills) == 3
    assert sorted(spills.values()) == [0, 0, 8]
    assert smoke.ptxas_spills(OCCUR_PTXAS, "flash_") == {}


def test_ptxas_registers_reads_the_line_after_each_kernel():
    """The registers of each function are those of the first "Used" line
    after its properties; a function without one takes the next one's, so
    the check reads reports where every function has its line."""
    regs = smoke.ptxas_registers(OCCUR_PTXAS, "occur_masked_kernelIi")
    assert list(regs.values()) == [48]
    assert smoke.ptxas_registers(OCCUR_PTXAS, "flash_") == {}


# device kernels as torch.profiler names them on the card
PROFILER_NAMES = {
    "occur_from_bitset": "void (anonymous namespace)::occur_kernel(unsigned "
                         "int const*, long, long, long, int, int*)",
    "occur_from_bitset_masked": "void (anonymous namespace)::"
                                "occur_masked_kernel<unsigned char>(unsigned "
                                "int const*, unsigned char const*, long)",
    "bitset_or": "void (anonymous namespace)::bitset_binary_kernel<"
                 "(anonymous namespace)::OrOp>(unsigned int const*)",
    "popcount_words": "void (anonymous namespace)::popcount_kernel(unsigned "
                      "int const*, long, bool, int*)",
    "sketch_union_popcount": "void (anonymous namespace)::"
                             "union_popcount_kernel(unsigned int const*)",
    "flash_attention": "void (anonymous namespace)::flash_wgmma_kernel<"
                       "__nv_bfloat16, 128, true>(CUtensorMap_st)",
    "greedy_sketch": "void (anonymous namespace)::greedy_sketch_kernel<0, "
                     "false, 2>(unsigned int const*, int, int, int, bool, "
                     "int, int, (anonymous namespace)::SketchRecord*, "
                     "unsigned char*, unsigned int*, int*)",
    "celf_eval": "void (anonymous namespace)::celf_eval_kernel(int const*, "
                 "int const*, unsigned char const*, long, unsigned int "
                 "const*, long, int const*, int, int, int*, unsigned int*)",
    "celf_apply": "void (anonymous namespace)::celf_apply_kernel(int const*, "
                  "int const*, unsigned char const*, long, unsigned int*, "
                  "long, int, int*)",
    "celf_select": "void (anonymous namespace)::celf_select_kernel<true, "
                   "32>((anonymous namespace)::SelectArgs)",
    "frontier_update": "void (anonymous namespace)::frontier_update_kernel("
                       "unsigned int const*, unsigned int*, long, bool, "
                       "unsigned int*)",
    "sketch_fold_rows": "void (anonymous namespace)::fold_rows_kernel("
                        "unsigned int*, int const*, long, int const*, long, "
                        "long, long, long, unsigned int, unsigned int, "
                        "bool, long*)",
    "sketch_scatter_or": "void (anonymous namespace)::scatter_or_kernel("
                         "unsigned int*, int const*, int const*, long, "
                         "long, long, int*)",
    "membership_rows": "void (anonymous namespace)::membership_kernel(int "
                       "const*, int const*, int const*, int, long, long, "
                       "unsigned char*)",
    "padded_greedy": "void (anonymous namespace)::padded_greedy_kernel(int "
                     "const*, int const*, long, long, int, int, int, long, "
                     "unsigned long long*, int*, unsigned char*, int*)",
    "refill_bfs": "void (anonymous namespace)::refill_bfs_kernel<0>(int "
                  "const*, int const*, float const*, unsigned int, int, int, "
                  "long, long, int, int, int*, unsigned int*, int*, int*, "
                  "int*, bool*, int*, long*, float const*, int const*)",
    "greedy_stacked": "(anonymous namespace)::greedy_stacked_kernel(int "
                      "const*, int const*, unsigned char const*, long, int, "
                      "long, int, int, (anonymous namespace)::StackedArgs, "
                      "unsigned long long*, int2*, int*, int*, int*, int*, "
                      "int*, int*, int*, int*, unsigned int*, int*, int*, "
                      "int*, float*)",
}
# further names of the same records' kernels
PROFILER_ALSO = {
    "flash_attention": ["void (anonymous namespace)::flash_simt_split_kernel"
                        "<float, 256, false>(float const*)",
                        "void (anonymous namespace)::flash_simt_kernel"
                        "<float, 64, true>(float const*)"],
    "sketch_union_popcount": ["void (anonymous namespace)::"
                              "union_popcount_row_kernel<true>(unsigned int "
                              "const*)"],
    "bernoulli_edges": ["void (anonymous namespace)::bernoulli_kernel<true>"
                        "(float const*, long const*, long, long, unsigned "
                        "char*)"],
    "queue_bfs": ["void (anonymous namespace)::queue_bfs_kernel(int const*, "
                  "int const*, float const*, unsigned int, int, int, long, "
                  "long, int*, unsigned int*, int*, int*, bool*, long*, "
                  "float const*, int const*)",
                  "void (anonymous namespace)::queue_bfs_kernel<2, true>(int "
                  "const*, int const*, float const*, unsigned int, int, int, "
                  "long, long, int, int*, unsigned int*, int*, int*, bool*, "
                  "long*, float const*, int const*)"],
    "greedy_flat": ["void (anonymous namespace)::greedy_flat_kernel<true, "
                    "false>(int const*, int const*, unsigned char const*, "
                    "long, int, long, int, int, int, unsigned long long*, "
                    "int*, int*, int*, int*, int*, int*, int*, int*, "
                    "(anonymous namespace)::VariantArgs)",
                    "void (anonymous namespace)::greedy_flat_kernel<false, "
                    "false>(int const*, int const*, unsigned char const*, "
                    "long, int, long, int, int, int, unsigned long long*, "
                    "int*, int*, int*, int*, int*, int*, int*, int*, "
                    "(anonymous namespace)::VariantArgs)",
                    "_ZN40_GLOBAL__N__greedy_cu18greedy_flat_kernelILb1ELb0E"
                    "EEvPKiS2_PKhlilii"],
    "greedy_flat_variant": ["void (anonymous namespace)::greedy_flat_kernel"
                            "<true, true>(int const*, int const*, unsigned "
                            "char const*, long, int, long, int, int, int, "
                            "unsigned long long*, int*, int*, int*, int*, "
                            "int*, int*, int*, int*, (anonymous namespace)::"
                            "VariantArgs)",
                            "void (anonymous namespace)::greedy_flat_kernel"
                            "<false, true>(int const*, int const*, unsigned "
                            "char const*, long, int, long, int, int, int, "
                            "unsigned long long*, int*, int*, int*, int*, "
                            "int*, int*, int*, int*, (anonymous namespace)::"
                            "VariantArgs)",
                            "_ZN40_GLOBAL__N__greedy_cu18greedy_flat_kernel"
                            "ILb0ELb1EEEvPKiS2_PKhlilii"],
    "greedy_sketch": ["void (anonymous namespace)::greedy_sketch_kernel"
                      "<2, false, 1>(unsigned int const*, int, int, int, "
                      "bool, int, int, (anonymous namespace)::SketchRecord*, "
                      "unsigned char*, unsigned int*, int*)",
                      "void (anonymous namespace)::greedy_sketch_kernel"
                      "<1, true, 1>(unsigned int const*, int, int, int, "
                      "bool, int, int, (anonymous namespace)::SketchRecord*, "
                      "unsigned char*, unsigned int*, int*)"],
    "celf_select": ["void (anonymous namespace)::celf_select_kernel<false, "
                    "0>((anonymous namespace)::SelectArgs)",
                    "void (anonymous namespace)::celf_select_kernel<true, "
                    "64>((anonymous namespace)::SelectArgs)"],
}


@pytest.mark.parametrize("name", sorted(PROFILER_ALSO))
def test_device_kernel_patterns_take_every_design(name):
    """A record's pattern matches each kernel its wrapper may launch (the
    split flash kernel, the row-per-thread union popcount, both trial
    loops) and no kernel of another record."""
    import re
    for key in PROFILER_ALSO[name]:
        assert re.search(smoke.DEVICE_KERNEL[name], key), key
        for other in smoke.DEVICE_KERNEL:
            if other != name and not (
                    {other, name} == {"bitset_or", "bitset_andnot"}):
                assert not re.search(smoke.DEVICE_KERNEL[other], key), \
                    (other, key)


@pytest.mark.parametrize("name", sorted(PROFILER_NAMES))
def test_device_kernel_patterns_pick_their_own_kernel(name):
    """Each record's pattern matches its kernel's profiler name and no
    other kernel's (popcount_kernel is a suffix of union_popcount_kernel,
    occur_kernel a substring of neither masked name)."""
    import re
    for other, key in PROFILER_NAMES.items():
        hit = re.search(smoke.DEVICE_KERNEL[name], key) is not None
        assert hit == (other == name), (name, other)


def _queue_round():
    """A queue round of 64 lanes on a coalesced reverse BA(300, 3) graph
    with WC weights, on the CPU: (g_rev, queue, lengths)."""
    from repro_torch.graph import csr, generators, weights
    from repro_torch.kernels import ops
    src, dst = generators.barabasi_albert(300, 3, seed=5)
    g_rev = csr.coalesce_ic(csr.reverse(weights.wc_weights(
        csr.from_edges(src, dst, 300, device="cpu"))))
    queue, lengths = ops.queue_bfs(g_rev.offsets, g_rev.indices,
                                   g_rev.weights, 0xC0FFEE, 64, qcap=300,
                                   ec=128)[:2]
    return g_rev, queue, lengths


def test_lane_work_walks_each_lanes_queue():
    import torch
    from repro_torch.graph import csr
    # rows of degree 0, two segments and one edge (three of the kernel's
    # segments), 1 and 64 (nodes 0..3)
    seg = smoke.SEGMENT_EDGES
    deg = [0, 2 * seg + 1, 1, 64]
    offs = torch.tensor([0] + list(torch.tensor(deg).cumsum(0)),
                        dtype=torch.int32)
    g = csr.CSRGraph(offs, torch.zeros(sum(deg), dtype=torch.int32),
                     torch.zeros(sum(deg)))
    nodes = torch.tensor([[3, 1, 0], [2, 3, 3], [0, 0, 0]],
                         dtype=torch.int32)
    w = smoke.lane_work(g, nodes, torch.tensor([3, 1, 1], dtype=torch.int32))
    assert w["deg"].tolist() == [[64, 2 * seg + 1, 0], [1, 0, 0], [0, 0, 0]]
    assert w["edges"].tolist() == [2 * seg + 65, 1, 0]
    # a row is one compaction, a long one one a segment; none past a length
    assert w["segments"].tolist() == [5, 1, 1]


def test_queue_bound_counts_the_rounds_work(h100):
    """Edges examined = the degrees of every queued node, lane by lane;
    bytes = each distinct row walked once (8 an edge, 8 a row), the queue
    rows written in full (4 a cell), 17 a lane; operations = one trial an
    examined edge, as the docstring of ``queue_bound`` counts them."""
    import numpy as np
    g_rev, queue, lengths = _queue_round()
    offs = g_rev.numpy()[0]
    examined, rows = 0, set()
    lane_edges, lane_segments = [], []
    for b in range(64):
        edges_b = segments_b = 0
        for u in queue[b, :lengths[b]].tolist():
            deg = int(offs[u + 1] - offs[u])
            edges_b += deg
            segments_b += max(1, -(-deg // smoke.SEGMENT_EDGES))
            rows.add(u)
        examined += edges_b
        lane_edges.append(edges_b)
        lane_segments.append(segments_b)
    row_edges = int(sum(offs[u + 1] - offs[u] for u in rows))
    bound, work = smoke.queue_bound(g_rev, queue, lengths)
    dequeued = int(lengths.sum())
    assert work == {"examined_edges": examined, "distinct_rows": len(rows),
                    "distinct_row_edges": row_edges,
                    "dequeued_nodes": dequeued,
                    "longest_lane_edges": max(lane_edges),
                    "longest_lane_segments": max(lane_segments)}
    # lanes share rows: the bytes count each once, the trials each walk
    assert dequeued > len(rows) and examined > row_edges > 0
    assert row_edges <= np.int64(offs[-1])
    assert queue.shape == (64, 300)
    nbytes = 8 * row_edges + 8 * len(rows) + 4 * 64 * 300 + 17 * 64
    assert bound["bound_bytes_ms"] == pytest.approx(nbytes / 3.35e9)
    alu_s = H100_SMS * 64 * H100_MHZ * 1e6
    assert bound["bound_ops_ms"] == pytest.approx(
        smoke.TRIAL_WORK_OPS["alu"] * examined / alu_s * 1e3)


def test_queue_bound_counts_a_shared_row_once(h100):
    """Two lanes that walk the same 64-edge row: 128 edges examined (two
    trials each) but 64 edges' bytes; the queue's zeros past each lane's
    length are not walked, but written."""
    import torch
    from repro_torch.graph import csr
    offs = torch.tensor([0, 64, 64, 65], dtype=torch.int32)
    g = csr.CSRGraph(offs, torch.zeros(65, dtype=torch.int32),
                     torch.zeros(65))
    queue = torch.tensor([[0, 1, 0], [0, 0, 0], [2, 0, 0]],
                         dtype=torch.int32)
    lengths = torch.tensor([2, 1, 1], dtype=torch.int32)
    bound, work = smoke.queue_bound(g, queue, lengths)
    assert work == {"examined_edges": 129, "distinct_rows": 3,
                    "distinct_row_edges": 65, "dequeued_nodes": 4,
                    "longest_lane_edges": 64, "longest_lane_segments": 2}
    nbytes = 8 * 65 + 8 * 3 + 4 * 9 + 17 * 3
    assert bound["bound_bytes_ms"] == pytest.approx(nbytes / 3.35e9)


def test_one_sm_bound_is_the_longest_lanes_trials_on_one_sm(h100):
    """The stand-in's longest lane (211,322 trials) on one SM: the ALU's
    14 operations a trial at 64 a clock bind, 46,227 clocks at 1,980 MHz;
    every other class, and all at the dispatch rate, would take less."""
    b = smoke.one_sm_bound(211_322)
    assert b["one_sm_bound_class"] == "alu"
    assert b["one_sm_bound_ms"] == pytest.approx(211_322 * 14 / 64
                                                 / H100_MHZ / 1e3)
    assert 0.02334 < b["one_sm_bound_ms"] < 0.02335
    assert smoke.one_sm_bound(0)["one_sm_bound_ms"] == 0


def _greedy_pool():
    """Three rows over n = 6: {0, 1, 2}, {2, 3} and {4} with its second
    element invalid; row capacity 32."""
    import torch
    flat = torch.tensor([0, 1, 2, 2, 3, 4, 5], dtype=torch.int32)
    ids = torch.tensor([0, 0, 0, 1, 1, 2, 2], dtype=torch.int32)
    valid = torch.tensor([1, 1, 1, 1, 1, 1, 0], dtype=torch.bool)
    return flat, ids, valid


def test_greedy_bound_counts_the_pool_and_the_steps(h100):
    """Seeds 2 then 4 (k = 2) on 3 blocks: bytes are the 7 elements read
    once (9 bytes each) and 2 x 8 bytes written; the argmax compares 6
    entries a step and the covered rows {0, 1, 2} decrement their 6 valid
    elements.  The working set: the prologue (count zeroed, 6 atomics and
    two reads; cursor written and 6 atomics; 33 row starts written, each
    searched in 3 reads of ids; 17 bytes an element; the 6 entries and
    their row starts, 20 bytes each), the exchanges (3 blocks write a
    16-byte record a step and read all 3), then one cover (the last step
    walks none) in which each block reads seed 2's 2 entries (12 bytes
    each) and the nodes of their rows' 5 elements (4 bytes each); Occur
    read from the scratch adds 4 n k."""
    import torch
    flat, ids, valid = _greedy_pool()
    seeds = torch.tensor([2, 4], dtype=torch.int32)
    b = smoke.greedy_bound(flat, ids, valid, seeds, n=6, num_rows=32, k=2,
                           blocks=3, shared=True)
    assert b["bound_bytes_ms"] == pytest.approx((9 * 7 + 16) / 3.35e9)
    alu_s = H100_SMS * 64 * H100_MHZ * 1e6
    assert b["bound_ops_ms"] == pytest.approx((2 * 6 + 6) / alu_s * 1e3)
    assert b["seed_rows_walked"] == 2 and b["decremented_elements"] == 6
    assert b["elements_walked_a_block"] == 5
    prologue = 12 * 6 + 4 * 6 + 4 * 6 + 4 * 6 + 4 * 33 + 4 * 33 * 3 \
        + 17 * 7 + 20 * 6
    assert b["working_prologue_bytes"] == prologue
    assert b["working_exchange_bytes"] == 16 * 2 * 3 * 4
    assert b["working_cover_bytes"] == 3 * (12 * 2 + 4 * 5)
    assert b["working_bytes"] == prologue + 16 * 2 * 3 * 4 \
        + 3 * (12 * 2 + 4 * 5)
    assert b["working_bytes_ms"] == pytest.approx(b["working_bytes"]
                                                  / 3.35e9)
    scratch = smoke.greedy_bound(flat, ids, valid, seeds, n=6, num_rows=32,
                                 k=2, blocks=3, shared=False)
    assert scratch["working_bytes"] == b["working_bytes"] + 4 * 6 * 2


@pytest.mark.parametrize("use_costs", [False, True])
def test_greedy_variant_bound_counts_a_bit_and_a_key_a_node(h100, use_costs):
    """Seeds 2, 4 and then the sentinel 6 (k = 3, three steps run) on the
    tiny pool: bytes add the 6 candidate bytes (and the 6 costs, 4 bytes
    each) and spent to greedy_bound's; operations are a blocked-bit test
    and a key compare a node a step and the 6 decrements on the ALU, and
    with costs a float32 compare a node a step plus a conversion (XU) and
    a divide (float32) for the 6 first scores and the 6 decremented
    elements, so the conversions then bound it."""
    import torch
    flat, ids, valid = _greedy_pool()
    seeds = torch.tensor([2, 4, 6], dtype=torch.int32)
    b = smoke.greedy_variant_bound(flat, ids, valid, seeds, n=6, num_rows=32,
                                   k=3, use_costs=use_costs, blocks=3,
                                   shared=True)
    assert b["steps_run"] == 3 and b["picks"] == 2
    assert b["decremented_elements"] == 6
    per_node = 5 if use_costs else 1
    assert b["bound_bytes_ms"] == pytest.approx(
        (9 * 7 + 8 * 3 + 4 + 6 * per_node) / 3.35e9)
    rate = H100_SMS * H100_MHZ * 1e6
    alu = 2 * 3 * 6 + 6
    if use_costs:
        assert b["bound_ops_class"] == "xu"
        assert b["bound_ops_ms"] == pytest.approx((6 + 6) / (16 * rate) * 1e3)
        assert b["bound_ops_ms"] > (alu + 3 * 6 + 6 + 6 + 6 + 6) \
            / (128 * rate) * 1e3
    else:
        assert b["bound_ops_class"] == "alu"
        assert b["bound_ops_ms"] == pytest.approx(alu / (64 * rate) * 1e3)
    assert b["working_exchange_bytes"] == 24 * 3 * 3 * 4


def test_masked_sketch_bound_counts_the_candidate_rows(h100):
    """Three node rows of two words, one candidate, k = 2 and both steps
    counted: bytes are the candidate's 2 words, the 5 outputs and the 3
    mask bytes; each step an OR and an add a candidate word and a compare
    a candidate row on the ALU and a popcount a candidate word (which set
    the time); the sweeps stay the design's, over all 3 rows."""
    b = smoke.masked_sketch_bound(3, 2, 2, 2, 1)
    assert b["bound_bytes_ms"] == pytest.approx((4 * 2 + 4 * 5 + 3) / 3.35e9)
    assert b["bound_ops_class"] == "xu"
    assert b["bound_ops_ms"] == pytest.approx(
        2 * 2 / (H100_SMS * 16 * H100_MHZ * 1e6) * 1e3)
    assert b["sweep_bytes"] == 2 * 4 * 6 and b["bound_rows"] == 1


def test_masked_sketch_bound_at_the_variant_cell(h100):
    """75,879 rows of 4 words with every third node a candidate (25,293),
    50 steps: the candidates' popcounts bound it at about 1.21 us, a third
    of the unmasked greedy's 3.63 us."""
    b = smoke.masked_sketch_bound(75_879, 4, 50, 50, 25_293)
    assert b["bound_by"] == "operations" and b["bound_ops_class"] == "xu"
    assert b["bound_ms"] == pytest.approx(0.0012097, rel=1e-3)
    assert b["sweep_bytes"] == 60_703_200


def test_celf_variant_batch_is_the_eval_call_after_the_commits():
    """The batch that chip_smoke times celf_eval on: the CELF variant's
    first eval call after 3 commits, padded to 32 ids, on the Covered
    words of the first 3 seeds' commits; the ops are restored after."""
    import torch
    from repro_torch.core import coverage as cov
    from repro_torch.kernels import ops, ref
    n, rows = 200, 300
    rng = np.random.default_rng(5)
    lens = rng.integers(1, 12, rows)
    nodes = np.full((rows, 12), n, np.int64)
    for i, ln in enumerate(lens):
        nodes[i, :ln] = rng.choice(n, size=ln, replace=False)
    store = cov.DeviceRRStore(n, sketch_k=256, device="cpu")
    store.append_batch((torch.tensor(nodes), torch.tensor(lens)))
    costs = (1 + np.arange(n) % 5).astype(np.float32)
    spec = cov.SelectionSpec(k_steps=20, n_group=n, group_quota=20,
                             cand=np.arange(n) % 2 == 0, costs=costs,
                             budget=20.0)
    seeds = cov.select_seeds_celf(store, 0, spec=spec).seeds.tolist()
    assert len(seeds) > 3
    eval_fn, apply_fn = ops.celf_eval, ops.celf_apply
    seen, cands = smoke.celf_variant_batch(store, spec, 3)
    assert ops.celf_eval is eval_fn and ops.celf_apply is apply_fn
    t = store.n_elems
    pool = (store.flat[:t], store.ids[:t], store.valid[:t])
    want = torch.zeros(store.row_capacity() // 32, dtype=torch.int32)
    for u in seeds[:3]:
        ref.celf_apply_ref(*pool, want, u)
    assert torch.equal(seen, want)
    assert cands.dtype == torch.int32 and cands.numel() == 32
    live = cands[cands >= 0].numpy()
    assert len(set(live.tolist())) == len(live) and spec.cand[live].all()
    assert not np.isin(live, seeds[:3]).any()


def test_greedy_pool_args_and_plain_seeds_agree_with_the_bound(h100):
    """pool_args hands the live pool and k = K to the greedy; on the tiny
    pool the plain greedy picks 2 then 4, the seeds the bound was given."""
    import torch
    from repro_torch.core import coverage as cov
    from repro_torch.kernels import ref
    store = cov.DeviceRRStore(6, device="cpu")
    store.append_batch((torch.tensor([[0, 1, 2], [2, 3, 6], [4, 6, 6]]),
                        torch.tensor([3, 2, 1])))
    args, kw = smoke.pool_args(store)
    assert kw == {"n": 6, "num_rows": 32, "k": smoke.K}
    assert [a.shape[0] for a in args] == [6, 6, 6]
    seeds, gains = ref.greedy_flat_ref(*args, **dict(kw, k=2))
    assert seeds.tolist() == [2, 4] and gains.tolist() == [2, 1]


def test_sketch_greedy_bound_counts_the_rows_once_and_the_steps(h100):
    """Three node rows of two words, k = 2 and both steps taken: bytes are
    the 6 words read once and the 5 outputs written; each step does an OR
    and an add a word and a compare a row on the ALU and a popcount a word,
    and the popcounts (at a quarter of the ALU's rate) set the operations'
    time; the sweeps read the rows once a step."""
    b = smoke.sketch_greedy_bound(3, 2, 2, 2)
    assert b["bound_bytes_ms"] == pytest.approx((4 * 6 + 4 * 5) / 3.35e9)
    xu_s = H100_SMS * 16 * H100_MHZ * 1e6
    assert b["bound_ops_class"] == "xu"
    assert b["bound_ops_ms"] == pytest.approx(2 * 6 / xu_s * 1e3)
    assert b["bound_by"] == "bytes"
    assert b["sweep_bytes"] == 2 * 4 * 6 and b["sketch_fits_l2"]


def test_sketch_greedy_bound_at_the_approximate_cell(h100):
    """75,879 rows of 4 words, 50 steps: the popcounts bound it at about
    3.6 us, above the 1.21 MB read once; the 50 sweeps move 60.7 MB."""
    b = smoke.sketch_greedy_bound(75_879, 4, 50, 50)
    assert b["bound_by"] == "operations" and b["bound_ops_class"] == "xu"
    assert b["bound_ms"] == pytest.approx(0.003630, rel=1e-3)
    assert b["sweep_bytes"] == 60_703_200
    assert b["sweep_bytes_ms"] == pytest.approx(0.018120, rel=1e-3)


def test_greedy_sketch_barrier_floor_counts_one_barrier_a_step():
    """The barrier floor that chip_smoke times for greedy_sketch: the
    prologue's grid barrier and one for each step run (the steps taken,
    and below k the one that finds no node); two steps' records of 32
    bytes a block."""
    from repro_torch.kernels import greedy as tgreedy
    assert tgreedy.sketch_barriers(50, 50) == 51
    assert tgreedy.sketch_barriers(40, 50) == 42
    assert tgreedy.SKETCH_RECORD_BYTES == 32


def test_selection_kernel_counts_match_the_sources():
    """Phase 2's ptxas counts: greedy.cu's two greedy_flat forms,
    greedy_flat_variant's two and its weighted form's two (state in shared
    memory or the scratch), its barrier floor, greedy_stacked and
    greedy_sketch's forms (registers, one kernel for
    1 or REG_ROWS = 2 rows a thread, shared, global with cov in shared
    memory or not); celf.cu's celf_eval, celf_apply and
    celf_select's four forms (cov_sk shared or not, top lists of LIST
    keys or the radix pick)."""
    from repro_torch.kernels import celf as tcelf
    from repro_torch.kernels import greedy as tgreedy
    assert tgreedy.REG_ROWS == 2
    assert smoke.GREEDY_KERNELS == 2 + 2 + 2 + 1 + 1 + 1 + 1 + 2
    assert tcelf.LIST == 32
    assert smoke.CELF_KERNELS == 2 + 2 * 2


@pytest.mark.parametrize("k,calls,barriers", [(50, 127, 306),
                                              (50, 123, 298), (5, 0, 7)])
def test_celf_list_path_barriers(k, calls, barriers):
    """celf_select's grid barriers on the top-list path: 2 in the
    prologue, 2 an eval call and 1 a seed (its last sweep); at the CELF
    cell's 127 [123] eval calls, 306 [298] against the radix pick's 560
    [544] (PERF.md)."""
    from repro_torch.kernels import celf as tcelf
    assert tcelf.list_barriers(k, calls) == barriers


def test_celf_select_layout_at_the_cell():
    """At the CELF cell (75,879 nodes, 16,384 rows, 35,538 elements, c =
    32) on the H100's grid: lists of 32 keys, the sketch union, the
    slice's sel, the pool's 270 pairs a block and, at 1,024 buckets, the
    slice's 575 sketch rows in shared memory beside the merge buffers (132
    + 66 lists); at 16,384 buckets the 512-word union still fits, the
    rows (1.2 MB a block) do not."""
    from repro_torch.kernels import celf as tcelf
    for cols, rows in ((32, True), (512, False)):
        lay = tcelf.select_layout(75_879, 16_384, 32, cols, 132, 58_080,
                                  35_538)
        assert (lay.list, lay.shared, lay.pool_on_chip) == (32, True, True)
        assert lay.rows_on_chip == rows
        assert lay.dynamic_bytes == (4 * cols + 8 * 32 * 198 + 4 * 576
                                     + 8 * 270 + (4 * 575 * 32 if rows
                                                  else 0))


def test_parent_sketch_select_equals_the_store_selection():
    """The parent's loop, kept as the before figure, gives the store's
    selection: seeds, gains, frac bytes and certificate, past the last
    node too (k > n pads with n)."""
    import numpy as np
    import torch
    from repro_torch.core import coverage as cov
    rng = np.random.default_rng(2)
    store = cov.SketchRRStore(40, sketch_k=256, device="cpu")
    store.append_batch((torch.tensor(rng.integers(0, 40, (300, 5))),
                        torch.tensor(rng.integers(0, 6, 300))))
    for k in (5, 45):
        want_info, got_info = {}, {}
        want = store.select(k, info_out=want_info)
        got = smoke.parent_sketch_select(store, k, got_info)
        assert torch.equal(got.seeds, want.seeds)
        assert torch.equal(got.gains, want.gains)
        assert got.frac.numpy().tobytes() == want.frac.numpy().tobytes()
        assert got_info == want_info
    assert got.seeds[-5:].tolist() == [40] * 5


def test_parent_sketch_append_equals_the_store_append():
    """The parent's fold, kept as the before figure, gives the store's own
    append: words, rows and elements, over batches with empty rows,
    lengths past W and a strided view."""
    import torch
    from types import SimpleNamespace
    from repro_torch.core import coverage as cov
    rng = np.random.default_rng(4)
    stores = [cov.SketchRRStore(50, sketch_k=96, sketch_mode=mode,
                                device="cpu") for mode in ("mix", "mix")]
    for _ in range(3):
        queue = torch.tensor(rng.integers(0, 52, (40, 11)).astype(np.int32))
        batch = SimpleNamespace(nodes=queue[:, :6], lengths=torch.tensor(
            rng.integers(-1, 9, 40).astype(np.int32)))
        smoke.parent_sketch_append(stores[0], batch)
        stores[1].append_batch(batch)
    assert torch.equal(stores[0].words, stores[1].words)
    assert (stores[0].n_rr, stores[0].n_elems) == \
        (stores[1].n_rr, stores[1].n_elems)


def test_parent_padded_select_equals_the_padded_selection():
    """The parent's loop, kept as the before figure, gives the padded
    greedy's seeds, gains and frac bytes (repeated nodes, k past n)."""
    import torch
    from repro_torch.core import coverage as cov
    rng = np.random.default_rng(6)
    lists = [rng.integers(0, 15, int(rng.integers(0, 7))).tolist()
             for _ in range(200)]
    store = cov.build_padded_store(lists, 15, device="cpu")
    for k in (4, 20):
        want = cov.select_seeds_padded(store, k)
        got = smoke.parent_padded_select(store, k)
        assert torch.equal(got.seeds, want.seeds)
        assert torch.equal(got.gains, want.gains)
        assert got.frac.numpy().tobytes() == want.frac.numpy().tobytes()


# ``-Xptxas -v`` of csrc/membership.cu built for sm_90a (CUDA 12.8)
MEMBERSHIP_PTXAS = """\
ptxas info    : Compiling entry function '_ZN46_GLOBAL__N__6506d55f_13_membership_cu_71b4c16a20padded_greedy_kernelEPKiS1_lliiilPyPiPhS3_' for 'sm_90a'
ptxas info    : Function properties for _ZN46_GLOBAL__N__6506d55f_13_membership_cu_71b4c16a20padded_greedy_kernelEPKiS1_lliiilPyPiPhS3_
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 48 registers, used 1 barriers, 140 bytes smem
ptxas info    : Compiling entry function '_ZN46_GLOBAL__N__6506d55f_13_membership_cu_71b4c16a17membership_kernelEPKiS1_S1_illPh' for 'sm_90a'
ptxas info    : Function properties for _ZN46_GLOBAL__N__6506d55f_13_membership_cu_71b4c16a17membership_kernelEPKiS1_S1_illPh
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 23 registers, used 0 barriers
"""


def test_ptxas_spills_reads_both_membership_kernels():
    """Phase 2's check of csrc/membership.cu: two kernels, no spill."""
    spills = smoke.ptxas_spills(MEMBERSHIP_PTXAS, "membership_cu")
    assert len(spills) == 2 and not any(spills.values())
    assert sorted("greedy" if "padded_greedy_kernel" in name else "scan"
                  for name in spills) == ["greedy", "scan"]


# ``-Xptxas -v`` of csrc/celf.cu built for sm_90a (CUDA 12.8)
CELF_PTXAS = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN39_GLOBAL__N__bbe03bef_7_celf_cu_5772f19a17celf_apply_kernelEPKiS1_PKhlPjliPi' for 'sm_90a'
ptxas info    : Function properties for _ZN39_GLOBAL__N__bbe03bef_7_celf_cu_5772f19a17celf_apply_kernelEPKiS1_PKhlPjliPi
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 15 registers, used 1 barriers, 4 bytes smem
ptxas info    : Compiling entry function '_ZN39_GLOBAL__N__bbe03bef_7_celf_cu_5772f19a16celf_eval_kernelEPKiS1_PKhlPKjlS1_iiPiPj' for 'sm_90a'
ptxas info    : Function properties for _ZN39_GLOBAL__N__bbe03bef_7_celf_cu_5772f19a16celf_eval_kernelEPKiS1_PKhlPKjlS1_iiPiPj
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 24 registers, used 1 barriers, 40960 bytes smem
"""


def test_ptxas_spills_reads_both_celf_kernels():
    """Phase 2's check of csrc/celf.cu: two kernels, no spill."""
    spills = smoke.ptxas_spills(CELF_PTXAS, "celf_")
    assert len(spills) == 2 and not any(spills.values())
    assert sorted("eval" if "celf_eval_kernel" in name else
                  "apply" if "celf_apply_kernel" in name else name
                  for name in spills) == ["apply", "eval"]
    assert smoke.ptxas_spills(CELF_PTXAS, "greedy_cu") == {}


@pytest.mark.parametrize("apply", [False, True])
def test_celf_bound_counts_the_pool_once(h100, apply):
    """The pool's node ids read once (4 bytes an element); only where an
    element holds a candidate (or u), its valid byte, the row id of a valid
    one and the distinct Covered words of those rows, read (and written by
    the commit); the candidates and their counts (the commit: its gain); a
    compare an element on the ALU.  At the stand-in's pool (35,538
    elements, 512 words) the bytes set it."""
    import torch
    t, nw = 35_538, 512
    rng = np.random.default_rng(3)
    nodes = np.array([7], np.int32) if apply else np.arange(32, dtype=np.int32)
    flat = rng.integers(0, 500, t).astype(np.int32)
    flat[:38] = nodes[np.arange(38) % len(nodes)]
    ids = np.sort(rng.integers(0, 8_704, t)).astype(np.int32)
    valid = np.ones(t, bool)
    valid[:38] = False
    hit = np.isin(flat, nodes)
    live = hit & valid
    words = len(set((ids[live] >> 5).tolist()))
    assert 0 < words < live.sum() < hit.sum()
    nbytes = 4 * t + hit.sum() + 4 * live.sum() + (
        8 * words + 4 if apply else 4 * words + 8 * len(nodes))
    b = smoke.celf_bound(torch.from_numpy(flat), torch.from_numpy(ids),
                         torch.from_numpy(valid),
                         torch.zeros(nw, dtype=torch.int32),
                         torch.from_numpy(nodes), apply)
    assert b["bound_bytes_ms"] == pytest.approx(nbytes / 3.35e9)
    alu_s = H100_SMS * 64 * H100_MHZ * 1e6
    assert b["bound_ops_ms"] == pytest.approx(t / alu_s * 1e3)
    assert b["bound_by"] == "bytes"
    # the pool's node ids dominate: under 5 bytes an element, not 9
    assert 4 * t / 3.35e9 < b["bound_ms"] < 5 * t / 3.35e9


def _celf_cpu_store(sketch_k):
    """A CPU exact store with an incremental sketch, filled by three
    appends of random padded batches (an empty row among them)."""
    import torch
    from repro_torch.core.coverage import DeviceRRStore
    rng = np.random.default_rng(11)
    n = 300
    store = DeviceRRStore(n, capacity=64, sketch_k=sketch_k, device="cpu")
    for r, w in ((40, 6), (64, 9), (33, 4)):
        lens = rng.integers(0, w + 1, r)
        lens[5] = 0
        nodes = np.stack([rng.choice(n, w, replace=False) for _ in range(r)])
        store.append_batch((torch.from_numpy(nodes.astype(np.int32)),
                            torch.from_numpy(lens)))
    return store


@pytest.mark.parametrize("sketch_k", [32, 256])
def test_host_copy_holds_the_pool_and_its_fold(sketch_k):
    """Phase 14's host copy: the same pool element for element, and its
    one-batch fold gives the incremental sketch of the three appends."""
    import torch
    store = _celf_cpu_store(sketch_k)
    copy = smoke.host_copy(store)
    t = store.n_elems
    assert copy.n_rr == store.n_rr and copy.n_elems == t
    assert torch.equal(copy.flat[:t], store.flat[:t])
    assert torch.equal(copy.ids[:t], store.ids[:t])
    assert torch.equal(copy.sketch_words(), store.sketch_words())


def test_check_celf_on_host_sees_a_wrong_fold_and_wrong_counts():
    """The check passes on a store against itself, and fails on one flipped
    sketch bit (the selection's seeds do not move, its eval counts may not)
    and on stats_out that differ."""
    import torch
    from repro_torch.core.coverage import select_seeds_celf
    store = _celf_cpu_store(64)
    stats = {}
    res = select_seeds_celf(store, 5, stats_out=stats)
    out = smoke.check_celf_on_host(store, res, stats)
    assert all(out["equal"].values()) and out["host_stats"] == stats
    with pytest.raises(AssertionError, match="stats_out"):
        smoke.check_celf_on_host(store, res, dict(
            stats, n_exact_evals=stats["n_exact_evals"] + 1))
    store.sketch_words()[3, 0] ^= 1
    with pytest.raises(AssertionError, match="sketch_words"):
        smoke.check_celf_on_host(store, res, stats)


# ``-Xptxas -v`` of csrc/celf.cu with celf_select built for sm_90a (CUDA
# 12.8; the select kernel's two forms)
CELF_SELECT_PTXAS = """\
ptxas info    : Compiling entry function '_ZN39_GLOBAL__N__bbe03bef_7_celf_cu_5772f19a18celf_select_kernelILb0EEEvNS_10SelectArgsE' for 'sm_90a'
ptxas info    : Function properties for _ZN39_GLOBAL__N__bbe03bef_7_celf_cu_5772f19a18celf_select_kernelILb0EEEvNS_10SelectArgsE
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 121 registers, used 1 barriers, 24800 bytes smem
ptxas info    : Compiling entry function '_ZN39_GLOBAL__N__bbe03bef_7_celf_cu_5772f19a18celf_select_kernelILb1EEEvNS_10SelectArgsE' for 'sm_90a'
ptxas info    : Function properties for _ZN39_GLOBAL__N__bbe03bef_7_celf_cu_5772f19a18celf_select_kernelILb1EEEvNS_10SelectArgsE
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 119 registers, used 1 barriers, 24800 bytes smem
""" + CELF_PTXAS


def test_ptxas_spills_reads_the_four_celf_kernels():
    """Phase 2's check of csrc/celf.cu: four kernels (both forms of
    celf_select, celf_eval and celf_apply), no spill."""
    spills = smoke.ptxas_spills(CELF_SELECT_PTXAS, "celf_")
    assert len(spills) == 4 and not any(spills.values())
    assert sum("celf_select_kernel" in name for name in spills) == 2
    assert smoke.ptxas_spills(CELF_SELECT_PTXAS.replace(
        "0 bytes spill stores", "8 bytes spill stores", 1), "celf_") != spills


def test_celf_select_bound_counts_this_runs_batches(h100):
    """The selection's bytes, each input once (a sketch and pool far under
    the L2): the node ids and valid bytes (5 an element), the row ids of
    the valid elements of every candidate and seed, the n sketch rows, and
    the seeds and gains; a compare an element for Occur, a call and a
    commit, an OR and an add (ALU) and a popcount a sketch word a seed.
    The calls' and commits' bytes as celf_bytes counts them are the
    working set, and the sweeps the sketch rows once a seed."""
    import torch
    from repro_torch.kernels import ref
    store = _celf_cpu_store(64)
    t, n, k = store.n_elems, store.n_nodes, 5
    pool = (store.flat[:t], store.ids[:t], store.valid[:t])
    sketch, rows = store.sketch_words(), store.row_capacity()
    batches = []
    seeds = ref.celf_select_ref(*pool, n=n, num_rows=rows, k=k, c=8,
                                sketch=sketch, calls_out=batches)[0].tolist()
    b = smoke.celf_select_bound(*pool, rows, batches, seeds, sketch, n)
    nodes = set(np.concatenate(batches).tolist()) | set(seeds)
    flat, valid = pool[0].numpy(), pool[2].numpy()
    live = int((np.isin(flat, sorted(nodes)) & valid).sum())
    want = 5 * t + 4 * live + 8 * k + 4 * n * 2
    assert b["bound_bytes"] == want and b["bound_batches"] == len(batches)
    assert b["bound_bytes_ms"] == pytest.approx(want / 3.35e9)
    ops = (1 + len(batches) + k) * t + 2 * k * n * 2
    alu_s = H100_SMS * 64 * H100_MHZ * 1e6
    assert b["bound_ops_ms"] >= ops / alu_s * 1e3
    assert b["working_bytes"] == sum(
        smoke.celf_bytes(*pool, rows, torch.from_numpy(c), False)
        for c in batches) + sum(
        smoke.celf_bytes(*pool, rows, torch.tensor([u]), True)
        for u in seeds)
    assert b["sweep_bytes"] == k * 4 * n * 2 and b["sketch_fits_l2"]
    nosk = smoke.celf_select_bound(*pool, rows, batches, seeds, None, n)
    assert nosk["bound_bytes"] == want - 4 * n * 2
    assert nosk["sweep_bytes"] == 0


@pytest.mark.parametrize("nbytes,reads,want", [
    (1000, 1, 1000), (1000, 50, 1000),
    (4 * 75_879 * 32, 50, 4 * 75_879 * 32),
    (50 * 2 ** 20, 7, 50 * 2 ** 20),
    (50 * 2 ** 20 + 10, 3, 50 * 2 ** 20 + 30),
    (4 * 75_879 * 512, 50, 4 * 75_879 * 512
     + 49 * (4 * 75_879 * 512 - 50 * 2 ** 20))])
def test_from_memory_counts_only_what_the_l2_cannot_keep(nbytes, reads,
                                                        want):
    """A read again comes from memory only past the L2's 50 MB: the
    1,024-bucket sketch (9.7 MB) once whatever the seeds, the 16,384-bucket
    one (155 MB) once and then all but 50 MB of each later sweep."""
    assert smoke.from_memory(nbytes, reads) == want


def _lt_round(qcap=None):
    """An LT round of 64 lanes on a reverse BA(300, 3) graph with WC
    weights on the CPU: (g_rev, rowcum, the round's outputs, seed)."""
    from repro_torch.core import lt
    from repro_torch.graph import csr, generators, weights
    from repro_torch.kernels import ops
    src, dst = generators.barabasi_albert(300, 3, seed=5)
    g_rev = csr.reverse(weights.wc_weights(
        csr.from_edges(src, dst, 300, device="cpu")))
    rowcum = lt.row_cumweights(g_rev)
    out = ops.lt_walk(g_rev.offsets, g_rev.indices, rowcum, 0xC0FFEE, 64,
                      qcap=300 if qcap is None else qcap)
    return g_rev, rowcum, out, 0xC0FFEE


def test_search_rounds_is_the_32_way_search():
    """csrc/lt.cu's search, replayed: one round for a row of at most 32
    edges (its last probe the row's total), four for 42,000; the edge is
    the first whose cumulative weight passes the draw, -1 past the total."""
    rc = np.cumsum(np.full(42_000, 1 / 42_000)).astype(np.float32)
    for u in (0.0, 0.3, 0.99999):
        rounds, j = smoke.search_rounds(rc, 0, 42_000, np.float32(u))
        assert rounds == 4 and j == int(np.searchsorted(rc, np.float32(u),
                                                        side="right"))
    short = np.float32([0.25, 0.5, 0.5, 0.75])
    assert smoke.search_rounds(short, 0, 4, np.float32(0.5)) == (1, 3)
    assert smoke.search_rounds(short, 0, 4, np.float32(0.75)) == (1, -1)
    assert smoke.search_rounds(short, 2, 2, np.float32(0.1)) == (0, -1)


@pytest.mark.parametrize("qcap", [None, 3])
def test_lt_bound_counts_the_walks_and_their_chains(h100, qcap):
    """lt_work replays every draw of the round (each search must end at
    the walk's next node) and counts the longest lane's dependent loads:
    its offsets, search rounds and indices; the bytes are the walk rows in
    full, 17 bytes a lane, 12 a draw and 4 an edge taken."""
    g_rev, rowcum, (walk, lengths, ovf, steps, _), seed = _lt_round(qcap)
    bound, work = smoke.lt_bound(g_rev, rowcum, walk, lengths, steps, seed)
    assert work["draws"] == int(steps.sum())
    assert work["longest_walk"] == int(lengths.max())
    # a draw loads its offsets and makes at least one search round; the
    # draws that take an edge load one index
    assert work["chain_loads"] >= 2 * int(steps.max())
    assert work["edges_taken"] >= int((lengths - 1).sum())
    nbytes = 4 * walk.numel() + 17 * 64 + 12 * work["draws"] \
        + 4 * work["edges_taken"]
    assert bound["bound_bytes_ms"] == pytest.approx(
        nbytes / smoke.HBM_BYTES_S * 1e3)
    if qcap is not None:
        assert bool(ovf.any())


def _stacked_store():
    """The tiny pool of :func:`test_greedy_pool_args_and_plain_seeds_agree_
    with_the_bound` in a store."""
    import torch
    from repro_torch.core import coverage as cov
    store = cov.DeviceRRStore(6, device="cpu")
    store.append_batch((torch.tensor([[0, 1, 2], [2, 3, 6], [4, 6, 6]]),
                        torch.tensor([3, 2, 1])))
    return store


def test_stacked_bound_sums_its_rows(h100):
    """A plain row of k = 2 (seeds 2, 4; every step runs), a candidate row
    of k = 3 over {0, 3} (picks 0 and 3, then the step that finds none)
    and a padding row: bytes are the 6 elements once, 17 bytes of scalars
    and 8 k_max + 4 of outputs a row, and the candidate row's 6 bytes;
    operations a compare a node a step (2 x 6) and the plain row's 6
    decrements, and a bit and a key a node a step (2 x 3 x 6) and the
    candidate row's 5 decrements (rows {0, 1} hold 0 or 3), on the ALU.
    The launch runs 3 steps: 2 + 2 x 3 grid barriers."""
    import torch
    from repro_torch.core import coverage as cov
    from repro_torch.kernels import ops
    store = _stacked_store()
    cand = np.isin(np.arange(6), [0, 3])
    reqs = [cov.StackedRequest(k_steps=2),
            cov.StackedRequest(k_steps=3, plain=False, cand=cand)]
    kw = cov.stacked_operands(store, reqs)
    assert kw["k_max"] == 4 and kw["ks"].tolist() == [2, 3]
    args, _ = smoke.pool_args(store)
    seeds, gains, spent = ops.greedy_stacked(*args, **kw)
    assert seeds.tolist() == [[2, 4, 6, 6], [0, 3, 6, 6]]
    assert smoke.stacked_steps(seeds, kw) == [2, 3]
    b = smoke.stacked_bound(*args, seeds, kw, blocks=3)
    assert b["steps_taken"] == 3 and b["grid_barriers"] == 8
    assert b["bound_bytes_ms"] == pytest.approx(
        (9 * 6 + 17 * 2 + 2 * (8 * 4 + 4) + 6) / 3.35e9)
    alu_s = H100_SMS * 64 * H100_MHZ * 1e6
    assert b["bound_ops_class"] == "alu"
    assert b["bound_ops_ms"] == pytest.approx(
        (2 * 6 + 6 + 2 * 3 * 6 + 5) / alu_s * 1e3)
    assert b["decremented_elements"] == 11


def test_check_stacked_holds_rows_to_their_solo_selections():
    """On the CPU (the plain versions on either side) phase 18's check
    passes the stand-in's mixes on the tiny pool, and raises on a row that
    differs from its solo selection."""
    import torch
    from repro_torch.core import coverage as cov
    from repro_torch.kernels import ops
    store = _stacked_store()
    args, _ = smoke.pool_args(store)
    for rows, mix in smoke.STACKED_BATCHES:
        reqs = smoke.stacked_requests(6, rows, mix)
        assert len(reqs) == rows
        kw = cov.stacked_operands(store, reqs, **smoke.stacked_geometry(6))
        got = ops.greedy_stacked(*args, **kw)
        check = smoke.check_stacked(args, kw, got)
        assert check["max_abs_err"] == 0 and check["solo_rows_equal"]
        assert len(smoke.solo_row_calls(args, kw)) == rows
    bad = (got[0].clone(), got[1], got[2])
    bad[0][0, 0] = 5
    with pytest.raises(AssertionError):
        smoke.check_stacked(args, kw, bad)


def test_stacked_problems_are_stackable_but_the_rider():
    from repro_torch.core.imm import IMMSolver
    from repro_torch.graph import csr, generators, weights
    from repro_torch.serve import occur_fastpath_eligible, stacked_eligible
    src, dst = generators.barabasi_albert(30, 2, seed=0)
    g = weights.wc_weights(csr.from_edges(src, dst, 30, device="cpu"))
    solver = IMMSolver(g, batch=16, seed=0, device="cpu")
    probs = smoke.stacked_problems(30, 64)
    assert [occur_fastpath_eligible(solver, p) for p in probs] == \
        [False] * 8 + [True]
    assert all(stacked_eligible(solver, p) for p in probs)
    reqs, geometry = solver.stacked_requests(
        [solver.prepare(p) for p in probs[:-1]])
    assert [r.plain for r in reqs] == [True] * 4 + [False] * 4
    assert [r.k_steps for r in reqs][:6] == [50, 10, 25, 5, 50, 10]
    assert geometry == {"n_group": 30, "n_groups": 1}

