"""The kernel report of `monte_carlo_gp_torch.profile_kernel`: the SASS
opcode mix read from `cuobjdump -sass` output and the registers and spills
read from a `ptxas -v` report, on text in the tools' formats; and the count
of overtake passes on the plain version, from which `chip_smoke.py` bounds
the kernels' work."""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from monte_carlo_gp_torch import profile_kernel as pk
from monte_carlo_gp_torch.config import sim_params_from_numpy
from monte_carlo_gp_torch.ops import race_kernel as rk

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
PLAN_FIXTURE = ROOT / "tests" / "data" / "torch_plan_bahrain2024.npz"

SASS = """
\tcode for sm_90a
\t\tFunction : _ZN12_GLOBAL__N_113season_kernelILi2EEEvPKfS2_S2_PKiPKjPiijj
\t.headerflags\t@"EF_CUDA_TEXMODE_UNIFIED EF_CUDA_64BIT_ADDRESS EF_CUDA_SM90"
        /*0000*/                   LDC R1, c[0x0][0x28] ;          /* 0x00000a00ff017b82 */
                                                                   /* 0x000fe40000000800 */
        /*0010*/                   BRA 0x10;                       /* 0xfffffffc00fc7947 */
\t\t..........

\t\tFunction : _ZN12_GLOBAL__N_111race_kernelILi1EEEvPKfS2_S2_Piiijjjj
        /*0000*/                   LDC R1, c[0x0][0x28] ;          /* 0x00000a00ff017b82 */
        /*0010*/                   S2R R0, SR_TID.X ;              /* 0x0000000000007919 */
        /*0020*/              @!P0 SHFL.IDX PT, R3, R2, RZ, 0x1f ; /* 0x00001fff02037589 */
        /*0030*/                   SHFL.BFLY PT, R4, R3, 0x10, 0x1f ;
        /*0040*/                   LDS.128 R4, [R5] ;
        /*0050*/               @P1 STS [R5], R4 ;
        /*0060*/                   MUFU.LG2 R6, R6 ;
        /*0070*/                   FADD R7, R7, R8 ;
        /*0080*/                   FSETP.GT.AND P0, PT, R7, RZ, PT ;
        /*0090*/                   IMAD.MOV.U32 R9, RZ, RZ, R7 ;
        /*00a0*/             @!UP0 UIADD3 UR4, UR4, 0x1, URZ ;
        /*00b0*/                   VOTE.ANY R9, PT, P0 ;
        /*00c0*/                   EXIT ;
        /*00d0*/                   BRA 0xd0;
        /*00e0*/                   NOP;
        /*00f0*/                   NOP;
"""

PTXAS = """
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_111race_kernelILi1EEEvPKfS2_S2_Piiijjjj' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_111race_kernelILi1EEEvPKfS2_S2_Piiijjjj
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 64 registers, used 0 barriers, 400 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_113season_kernelILi4EEEvPKfS2_S2_PKiPKjPiijj' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_113season_kernelILi4EEEvPKfS2_S2_PKiPKjPiijj
    16 bytes stack frame, 12 bytes spill stores, 8 bytes spill loads
ptxas info    : Used 168 registers, used 1 barriers, 408 bytes cmem[0]
"""


def test_sass_mix_counts_each_kernels_opcodes_by_class():
    mix = pk.sass_mix(SASS)
    assert set(mix) == {"race_kernel<1>", "season_kernel<2>"}
    assert mix["race_kernel<1>"] == {
        "shuffle": 2, "shared load/store": 2, "MUFU": 1, "float": 2, "vote/branch": 3,
        "global/constant memory": 1, "integer": 3,
    }
    assert mix["season_kernel<2>"]["global/constant memory"] == 1
    assert mix["season_kernel<2>"]["vote/branch"] == 1
    assert sum(mix["season_kernel<2>"].values()) == 2


def test_ptxas_report_reads_registers_and_spills_per_kernel():
    report = pk.ptxas_report(PTXAS)
    assert report == {
        "race_kernel<1>": dict(stack=0, spill_stores=0, spill_loads=0, registers=64),
        "season_kernel<4>": dict(stack=16, spill_stores=12, spill_loads=8, registers=168),
    }


@pytest.mark.parametrize("mangled, name", [
    ("_ZN12_GLOBAL__N_111race_kernelILi3EEEvPKfS2_S2_Piiijjjj", "race_kernel<3>"),
    ("_ZN12_GLOBAL__N_113season_kernelILi1EEEvPKfS2_S2_PKiPKjPiijj", "season_kernel<1>"),
    ("_ZN12_GLOBAL__N_111race_kernelILi1ELi1EEEvPKfS2_S2_Piiijjjj", "race_kernel<1>"),
    ("_ZN12_GLOBAL__N_111race_kernelILi2ELi3EEEvPKfS2_S2_Piiijjjj", "race_kernel<2, 3>"),
    ("_ZN12_GLOBAL__N_113season_kernelILi2ELi3EEEvPKfS2_S2_PKiPKjPiijj", "season_kernel<2, 3>"),
    ("_ZN12_GLOBAL__N_113season_kernelILi4ELi1EEEvPKfS2_S2_PKiPKjPiijj", "season_kernel<4>"),
    ("_Z10other_kernelv", None),
])
def test_kernel_name_demangles_the_race_kernels(mangled, name):
    assert pk.kernel_name(mangled) == name


def _plan_inputs():
    with np.load(PLAN_FIXTURE) as f:
        fields = {k: f[k] for k in f.files}
    return rk.pack_inputs(sim_params_from_numpy(fields))


def test_overtake_passes_counts_each_races_live_and_swapping_passes():
    """A season of two races of the Bahrain plan (57 and 30 laps, 256
    simulations each) gives one (live, swapping) pair per race: pass 1 of
    every lap is live, a later pass only after one that swapped, so the live
    passes are the laps plus the swaps of passes 1 and 2. Race 0 counts as
    the single race of its seed does, and the plain version is restored."""
    pmat, scal, grid_log = _plan_inputs()
    n, laps, seeds = 256, [57, 30], [1, 2]
    pair = lambda t: torch.stack([t, t])
    real_race, real_pass = rk.race_counts_plain, rk._overtake_pass
    with pk.overtake_passes() as races:
        rk.season_counts_plain(pair(pmat), pair(scal), pair(grid_log), laps, n, seeds)
    assert (rk.race_counts_plain, rk._overtake_pass) == (real_race, real_pass)
    counts = [(int(live), int(swapping)) for live, swapping in races]
    assert len(counts) == 2
    for (live, swapping), lp in zip(counts, laps):
        sim_laps = n * (lp - 1)
        assert sim_laps < live < 3 * sim_laps
        # what pass 3 swapped: the swapping passes that made no later pass live
        assert 0 <= sim_laps + swapping - live <= swapping
    with pk.overtake_passes() as single:
        rk.race_counts_plain(pmat, scal, grid_log, laps[0], n, seed=seeds[0])
    assert [(int(a), int(b)) for a, b in single] == counts[:1]


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("d, scan", [(20, 5), (32, 5), (40, 6), (128, 6)])
def test_race_flops_counts_the_pass_work_of_the_run(d, scan):
    """chip_smoke's operation count: with every pass live and swapping it is
    61 + 3 x (11 + the prefix max's steps) per car and further lap; a dead
    pass adds nothing, a live one 4 and a swapping one 7 + the steps more."""
    smoke = _chip_smoke()
    n, laps = 1_000, 57
    passes = 3 * n * (laps - 1)
    every = smoke.race_flops(d, laps, n, (passes, passes))
    assert every == n * d * (17 * d + 49 + (laps - 1) * (61 + 3 * (11 + scan)))
    base = smoke.race_flops(d, laps, n, (0, 0))
    assert base == n * d * (17 * d + 49 + (laps - 1) * 61)
    assert smoke.race_flops(d, laps, n, (1, 0)) - base == 4 * d
    assert smoke.race_flops(d, laps, n, (1, 1)) - base == (11 + scan) * d
