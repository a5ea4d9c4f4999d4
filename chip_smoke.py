#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (`amcx_torch`).

Run from the root of a checkout on a machine with one CUDA card:

    python3 chip_smoke.py

It builds the kernels from ``amcx_torch/csrc`` (first use, one ``nvcc`` per
source, in parallel), holds each one against its plain PyTorch version on
the card at the main paths' shape, and drives the main paths at full
width:

- phases 2-4: ``amcx_torch.price_option(engine="mega")`` on the Philox
  pathgen (kernels ``gbm_paths`` and ``lsmc_mega``) against CRR-2000, at
  1,048,576 paths x 100 steps;
- phases 5-7: the fused per-step engine (kernels ``lsmc_step_moments`` and
  ``lsmc_step_apply``) and the induction kernel's cf/tau planes, then
  ``price_option(engine="fused")`` against CRR-2000, a down-and-in put
  against the CRR barrier tree, a European put against Black-Scholes, and
  the pathwise Greeks routes of ``amcx_torch.price_and_greeks`` against
  the closed form;
- phases 8-10: the Andersen-Broadie Bermudan max-call (1,048,576 paths,
  9 exercise dates, 5 and 2 assets): the multi-asset step kernels
  ``ma_step_moments``/``ma_step_apply``, the induction kernel ``ma_mega``,
  the kernel of their inputs ``ma_prepare`` and the basket pathgen kernel
  ``gbm_multi`` (independent and correlated assets) against their plain
  versions, bit for bit, then
  ``amcx_torch.price_max_call(engine="mega"|"fused")`` against the
  published values 26.15 (5 assets) and 13.90 (2 assets);
- phases 11-12: the strike/maturity book (``book-16-1M``: 16 American puts,
  strikes 80..120, S0 = 95, 1,048,576 paths x 100 steps): the book kernel
  ``lsmc_book`` against its plain version in four cases, then
  ``amcx_torch.price_strike_grid(engine="mega")`` on the Philox pathgen
  against CRR-2000 per strike, the xla book, the single-option kernel and,
  for mixed maturities and the Greeks ladder, the xla routes;
- phases 13-14: zero-path-memory pricing: the kernel ``lsmc_fusedpath``,
  which regenerates the paths inside the induction in one cooperative
  launch, against its plain version in eight cases (degrees 0, 4 and 10,
  an uneven grid) and against ``lsmc_mega`` on the same paths, then
  ``price_option(engine="fusedpath")`` (the put against CRR-2000, a
  down-and-in put against the CRR barrier tree, 1M x 1000 steps) and
  ``price_out_of_sample`` fitted on 1M paths and replayed on 16 blocks of
  1M, with the time and device memory of a pricing beside the
  pathgen + ``lsmc_mega`` pipeline's;
- phases 15-16: swing options (multiple stopping): the kernel
  ``lsmc_swing`` against its plain version in five cases at 1,048,576
  paths and against ``lsmc_mega`` at one right, then
  ``amcx_torch.price_swing_option(engine="mega")`` on the Philox pathgen
  (the published 3-rights put at 1M x 100) against the rights lattice, and
  ``price_swing_contract(engine="mega")`` (the published volume contract,
  an 11-rights forward up-swing at 1M x 20) against its composed lattice
  value;
- phases 17-18: scrambled-Sobol QMC: the kernel ``sobol_gbm`` against its
  plain version in increment and bridge order at 1M x 100 (the bridge order
  also at 20 steps and at its step cap) and its point set against scipy's,
  then ``simulate_gbm_qmc_device`` into ``lsmc_mega`` on
  the flagship put against CRR-2000, and the bridge-order European put
  against Black-Scholes;
- phase 19: the CCR exposure profile: the kernel ``ccr_exposures``
  (EPE, PFE-5 and PFE-95 of every step from kernel 2's all-paths
  coefficients) against its plain version at 1,048,576 x 100, bit for bit,
  then ``price_option(engine="mega", surface_stats=True)`` (each of kernel
  1, kernel 2 and the exposure kernel launched once; the price and stderr
  the bits of the call without the profile);
- phase 20: randomized-QMC pricing through the public entry,
  ``price_option(engine="mega")`` with ``SimConfig(backend="sobol-bridge")``
  at 1,048,576 x 100: a new seed builds its direction tables once on the
  card (the table kernel of ``sobol_gbm``, no host-to-device copy) and
  launches ``sobol_gbm`` and ``lsmc_mega`` once each; the same seed again
  builds nothing and copies nothing to the card.

It times the pricings, each kernel, each plain version and, where one
PyTorch call computes the same function, that call, with CUDA events, and
computes each kernel's bound: the larger of the bytes it must move over the
card's memory rate and its arithmetic over the card's peak rates. For
kernels 2, 4, 5, 8, 9, 7, 3, 6 and 10 (phases 4, 5, 8, 9, 11, 12, 14, 15)
it also prints the device time and launches by kernel (``torch.profiler``)
beside their design floors: the bytes they must move and their f32 -> f64
conversions at 16 a clock a SM (for kernels 8 and 7 also their DMMA at the
FP64 tensor cores' rate, both counted a path-step in the SASS this run
built); for kernels 1 and 11 (phases 2 and 17) the
device time beside their issue floor, SASS instructions a path-step (as
this run built them, by cuobjdump) at 4 a clock a SM; for kernel 5 also the
wrapper's host time a call (phase 5). Kernels 2 and 7 are held to their plain
versions bit for bit (phases 3, 6 and 9).
Any failed phase raises (non-zero exit). Without a CUDA device, or outside a
checkout, it exits non-zero and prints no result.

Output: one line per phase, then the card's name and power limit, then one
JSON line with the kernels' numbers, then the result line
``{"ok": true, "device": {...}}``.
"""

import json
import math
import re
import statistics
import subprocess
import sys
import time

from perfbench.roofline import bound_s

N_PATHS = 1_048_576
N_STEPS = 100
S0, R, SIGMA, STRIKE, T = 100.0, 0.01, 0.2, 100.0, 1.0
SEED = 20261016
# the Andersen-Broadie Bermudan max-call and its published values
MC_DATES, MC_R, MC_Q, MC_SIGMA, MC_T = 9, 0.05, 0.10, 0.2, 3.0
MC_VALUES = {5: 26.15, 2: 13.90}
MC_TOL = 0.35
# book-16-1M (amcx's published book set-up, scripts/make_results.py:335-345)
BOOK_S0, BOOK_N = 95.0, 16
BOOK_CRR_TOL = 0.2
# the zero-path-memory route (amcx's scale configurations,
# scripts/make_results.py:253-275 and :310-327)
OOS_BLOCKS, DEEP_STEPS = 16, 1000
FP_UNEVEN_PATHS = 1_000_004  # a multiple of 4 that fills no grid of 256-thread blocks evenly
FP_MEMORY_CAP = 64 * 2 ** 20
# swing options: amcx's published rights ladder and volume contract
# (scripts/make_results.py:660-720): S0 = 100, r = 5%, sigma = 25%, T = 1
SW_R, SW_SIGMA, SW_K, SW_RIGHTS = 0.05, 0.25, 105.0, 3
SW_CONTRACT = dict(K=100.0, T=1.0, q_take_min=0.5, q_take_max=1.0, Q_min=12.0, Q_max=16.0,
                   option_type="put")
SW_CONTRACT_STEPS = 20
# scrambled-Sobol QMC on the flagship put: the absolute gates of one scramble
QMC_CRR_TOL, QMC_BS_TOL = 0.02, 0.005

# the card's byte and arithmetic peaks are the benchmark's
# (perfbench/peaks.json, read by perfbench/roofline.py bound_s)
# f32 <-> f64 conversions: 16 a clock a SM (CUDA C++ Programming Guide,
# arithmetic throughput, compute capability 9.0) x 132 SMs x the 1.98 GHz
# boost clock; kernel 3 converts every f32 product before its f64 add,
# kernels 7 and 8 each column of X once a path
F64_CONVERSIONS_PER_S = 16 * 132 * 1.98e9
# the FP64 tensor cores (mma.sync f64): 67 TFLOP/s dense on an H100 SXM
# (NVIDIA's data sheet); an m8n8k4 is 256 multiply-adds. Kernels 7 and 8
# form their moments' exact f64 products there
FP64_TENSOR_FLOPS = 67e12
# the moments' X = [c w | y w | 0] at m = 21: 3 column blocks of 8, so 6
# upper 8 x 8 tiles, each an mma m8n8k4 (256 multiply-adds) every 4 paths
# (csrc/ma_moments.cuh)
MA_COL_BLOCKS, MA_TILES = 3, 6
DMMA_FLOPS = 2 * 8 * 8 * 4
# instruction issue: 4 warp instructions a clock a SM (32 threads each) x
# 132 SMs x the 1.98 GHz boost clock (the SM clock nvidia-smi reads under
# load). The pathgen kernels' design floor is their SASS instructions a
# path-step at that rate. This run counts them in the libraries it built
# (cuobjdump beside nvcc, issue_model below: kernel
# 1's step quad; kernel 11's increment chunk with its compaction and dense
# tail-form loops, its bridge row with a born and an other entry) and
# weighs the loops that depend on the data by this run's data (phases 2
# and 17)
THREAD_INSTR_PER_S = 4 * 32 * 132 * 1.98e9
# paths a thread and steps a pass of the pathgen kernels' loops
# (csrc/gbm.cu kGbmPaths and its quad; csrc/sobol_gbm.cu kIncPaths,
# kIncSteps and kBridgePaths)
GBM_QUAD_PATH_STEPS = 4 * 4
INC_CHUNK_STEPS, INC_PATHS, BRIDGE_PATHS = 4, 4, 4


def _bound(n_bytes, f32_ops=0.0, f64_ops=0.0, tensor_f64_ops=0.0):
    """Least time the card could take (ms): the larger of the bytes over the
    memory rate and the operations over the peak rate of their type
    (`perfbench.roofline.bound_s`; f64 products and sums that the FP64
    tensor cores can form at FP64_TENSOR_FLOPS), and which of the two it
    is."""
    t_bytes = bound_s({"bytes": n_bytes})
    t_ops = bound_s({"f32": f32_ops, "f64": f64_ops}) + tensor_f64_ops / FP64_TENSOR_FLOPS
    return (t_bytes * 1e3, "bytes") if t_bytes >= t_ops else (t_ops * 1e3, "operations")


# the pathgen kernels' SASS: which instructions each loop issues a pass

_INSTR = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")
_FUNC = re.compile(r"Function : (\S+)")


def sass_functions(text: str):
    """Each function of a ``cuobjdump -sass`` listing (of a cubin or of a
    shared library): its (address, instruction) pairs in address order."""
    out, instrs = {}, None
    for line in text.splitlines():
        m = _FUNC.search(line)
        if m:
            out[m.group(1)] = instrs = []
            continue
        m = _INSTR.search(line)
        if m and instrs is not None:
            instrs.append((int(m.group(1), 16), m.group(2)))
    return out


def _opcode(ins: str) -> str:
    return re.sub(r"^@!?U?P[T0-9]+\s+", "", ins).split()[0]


def _loops(instrs):
    """(start, end) of each loop: a branch back to a lower address."""
    out = []
    for addr, ins in instrs:
        m = re.search(r"\bBRA\b.*?(0x[0-9a-f]+)", ins)
        if m and int(m.group(1), 16) < addr:
            out.append((int(m.group(1), 16), addr))
    return out


def _real(instrs, lo, hi, opcode=None):
    """Instructions in [lo, hi] other than NOP (or only those of ``opcode``)."""
    return sum(1 for a, i in instrs if lo <= a <= hi and _opcode(i) != "NOP"
               and (opcode is None or _opcode(i) == opcode))


def sass_loops(text: str):
    """Per function of a ``cuobjdump -sass`` listing: its instruction count
    and each loop closed by a backward branch (start, end, instructions,
    and the counts of a few opcode classes inside)."""
    out = {}
    for func, instrs in sass_functions(text).items():
        loops = []
        for lo, addr in _loops(instrs):
            ops = [_opcode(i).split(".")[0] for a, i in instrs if lo <= a <= addr]
            cls = {}
            for op in ops:
                key = ("MUFU" if op == "MUFU" else "mem" if op[:3] in ("LDG", "STG", "LDS", "STS",
                                                                     "LDC", "LDL", "STL")
                       else "branch" if op in ("BRA", "CALL", "RET", "BSSY", "BSYNC", "EXIT")
                       else "fp32" if op in ("FADD", "FMUL", "FFMA", "FSETP", "FSEL", "FMNMX",
                                             "FCHK")
                       else "int" if op[:1] in ("I", "L", "S") or op in ("LEA", "SEL", "SHF",
                                                                         "POPC", "FLO", "PRMT")
                       else "other")
                cls[key] = cls.get(key, 0) + 1
            loops.append((lo, addr, len(ops), sum(1 for o in ops if o != "NOP"), cls))
        out[func] = (len(instrs), loops)
    return out


def issue_model(text: str):
    """The instruction counts that the pathgen kernels' issue floors weigh,
    from a ``cuobjdump -sass`` listing of ``csrc/gbm.cu`` or
    ``csrc/sobol_gbm.cu`` as built. Every instruction of a region counts as
    issued once a pass (a rarely taken slow path too). Keys, where the
    listing holds the kernel and its loops have the expected nesting:

    - ``gbm_paths``: ``quad``, the step-quad loop of the 16-byte-store
      instance (4 paths x 4 steps a pass);
    - ``sobol_gbm`` (increment order): ``chunk``, the chunk loop (4 steps x
      4 paths) without its two inner loops; ``compaction``, the loop that
      lists a thread's tail points (one pass a point of the warp's busiest
      lane); ``tail``, the dense tail-form loop, which evaluates
      ``tail_points`` points a lane a pass (its remainder runs in the chunk's
      straight code);
    - ``sobol_gbm_bridge``: ``row``, the row loop (4 paths) without its
      entry loop; ``born``, the entry loop body on an entry whose Sobol
      dimension is born there (all of it); ``other``, on any other entry (the
      body less the region that a born entry alone runs).
    """
    model = {}
    for name, instrs in sass_functions(text).items():
        loops = _loops(instrs)
        if not loops:
            continue
        outer = max(loops, key=lambda lo_hi: lo_hi[1] - lo_hi[0])
        inside = [lp for lp in loops if lp != outer and outer[0] <= lp[0] and lp[1] <= outer[1]]
        if "gbm_paths_kernelILb0E" in name:
            innermost = [lp for lp in loops if not any(
                o != lp and lp[0] <= o[0] and o[1] <= lp[1] for o in loops)]
            model["gbm_paths"] = {"quad": max(_real(instrs, *lp) for lp in innermost)}
        elif "sobol_increment_kernel" in name:
            tail = [lp for lp in inside if _real(instrs, *lp, "MUFU.RSQ")]
            scan = [lp for lp in inside if not any(_opcode(i).startswith("MUFU")
                                                   for a, i in instrs if lp[0] <= a <= lp[1])]
            if len(tail) == 1 and len(scan) == 1 and len(inside) == 2:
                model["sobol_gbm"] = {
                    "chunk": _real(instrs, *outer) - _real(instrs, *tail[0])
                    - _real(instrs, *scan[0]),
                    "compaction": _real(instrs, *scan[0]), "tail": _real(instrs, *tail[0]),
                    "tail_points": _real(instrs, *tail[0], "MUFU.RSQ")}
        elif "sobol_bridge_kernel" in name and len(inside) == 1:
            lo, hi = inside[0]
            body = _real(instrs, lo, hi)
            # the regions a forward branch inside the entry loop skips; the
            # born entries' own code is the largest that holds a MUFU
            skipped = []
            for addr, ins in instrs:
                m = re.search(r"\bBRA\b.*?(0x[0-9a-f]+)", ins)
                if lo <= addr <= hi and m and addr < int(m.group(1), 16) <= hi:
                    region = [i for a, i in instrs if addr < a < int(m.group(1), 16)]
                    if any(_opcode(i).startswith("MUFU") for i in region):
                        skipped.append(sum(1 for i in region if _opcode(i) != "NOP"))
            if skipped:
                model["sobol_gbm_bridge"] = {"row": _real(instrs, *outer) - body, "born": body,
                                             "other": body - max(skipped)}
    return model


def moments_model(text: str):
    """The moments' tensor-core loop (csrc/ma_moments.cuh ``tile_products``)
    of kernels 7 and 8 at 5 assets, all paths, from a ``cuobjdump -sass``
    listing of ``csrc/lsmc_ma_mega.cu`` or ``csrc/ma_step.cu`` as built: the
    innermost loop that issues DMMA with one widening a load and MA_TILES
    DMMA a MA_COL_BLOCKS loads (a k-step of 4 paths: one load of each
    column block a lane, one m8n8k4 a tile). Keys ``ma_mega`` and
    ``ma_step``: its shared-memory loads, F2F.F64.F32 and DMMA a pass, and
    per path-step the f32 -> f64 widenings (32 lanes each) and the DMMA, a
    pass taking 4 paths a MA_COL_BLOCKS loads."""
    model = {}
    for name, instrs in sass_functions(text).items():
        key = ("ma_mega" if "ma_mega_step_kernelILi5ELb0E" in name
               else "ma_step" if "ma_step_moments_kernelILi5ELb0E" in name else None)
        if key is None:
            continue
        loops = [lp for lp in _loops(instrs)
                 if any(_opcode(i).startswith("DMMA") for a, i in instrs if lp[0] <= a <= lp[1])]
        inner = [lp for lp in loops if not any(
            o != lp and lp[0] <= o[0] and o[1] <= lp[1] for o in loops)]
        for lo, hi in inner:
            ops = [_opcode(i) for a, i in instrs if lo <= a <= hi]
            dmma = sum(1 for o in ops if o.startswith("DMMA"))
            widen = sum(1 for o in ops if o == "F2F.F64.F32")
            loads = sum(1 for o in ops if o.startswith(("LDS", "LD.")))
            if (loads and widen == loads and dmma * MA_COL_BLOCKS == MA_TILES * loads
                    and (key not in model or loads > model[key]["loads"])):
                paths = 4 * loads / MA_COL_BLOCKS
                model[key] = {"loads": loads, "widen": widen, "dmma": dmma,
                              "widenings_per_path_step": 32 * widen / paths,
                              "dmma_per_path_step": dmma / paths}
    return model


def _sass_model(build_paths):
    """The pathgen kernels' loop counts (:func:`issue_model`) and the
    max-call moments' (:func:`moments_model`) in the SASS of the libraries
    this run built, or ``{}`` where the toolkit has no cuobjdump."""
    from pathlib import Path

    from amcx_torch.ops import _build

    cuobjdump = Path(_build._nvcc()).parent / "cuobjdump"
    model = {}
    for path in build_paths if cuobjdump.is_file() else ():
        name = Path(path).name
        pathgen = name.startswith(("libgbm_", "libsobol_gbm_"))
        if pathgen or name.startswith(("libma_step_", "liblsmc_ma_mega_")):
            proc = subprocess.run([str(cuobjdump), "-sass", path], capture_output=True,
                                  text=True, timeout=300)
            if proc.returncode == 0:
                model.update(issue_model(proc.stdout) if pathgen else moments_model(proc.stdout))
    return model


def _issue_floor_ms(per_path_step, path_steps):
    """A pathgen kernel's design floor (ms): its SASS instructions over the
    card's issue rate (None where they were not counted)."""
    if per_path_step is None:
        return None
    return per_path_step * path_steps / THREAD_INSTR_PER_S * 1e3


def _floor_text(floor_ms, per_path_step):
    if floor_ms is None:
        return "not measured (no SASS count: no cuobjdump, or loops not found)"
    return (f"{floor_ms:.4f} ms ({per_path_step:.2f} SASS instructions a path-step, "
            f"counted in this run's build)")


def _require(cond, what):
    if not cond:
        raise RuntimeError(f"chip_smoke: check failed: {what}")


def _time_ms(torch, fn, reps, warm):
    """Median milliseconds of ``fn()`` over ``reps`` runs after ``warm``
    warm-ups, each run between two CUDA events."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _host_us(torch, fn, calls):
    """Host microseconds a call of ``fn`` (its enqueue: no sync between the
    calls), after a warm-up."""
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter_ns()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter_ns()
    torch.cuda.synchronize()
    return (t1 - t0) / calls / 1e3


def _profile(torch, fn, reps):
    """Device time of ``reps`` calls of ``fn`` under torch.profiler: µs of
    device time per call, the device idle share of the traced window (first
    to last device event) and the six kernels with the most device time (µs
    and launches per call); None when the profiler records no device
    activity."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    if not events:
        return None
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    busy, (lo, hi) = 0.0, spans[0]
    for start, end in spans[1:]:
        if start > hi:
            busy, lo, hi = busy + hi - lo, start, end
        else:
            hi = max(hi, end)
    busy += hi - lo
    per_name, count = {}, {}
    for e in events:
        per_name[e.name] = per_name.get(e.name, 0.0) + e.time_range.end - e.time_range.start
        count[e.name] = count.get(e.name, 0) + 1
    top = sorted(per_name.items(), key=lambda kv: -kv[1])[:6]
    return {"device_us_per_call": busy / reps,
            "idle_share": 1.0 - busy / (spans[-1][1] - spans[0][0]),
            "top_us_per_call": {name[:60]: us / reps for name, us in top},
            "launches_per_call": {name[:60]: count[name] / reps for name, _ in top}}


def _kernel_us(torch, fn, reps, name):
    """Device µs a launch of the kernel whose name holds ``name`` over
    ``reps`` calls of ``fn`` under torch.profiler, and the launches a call
    the profiler recorded; None when it recorded none."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    spans = [e.time_range.end - e.time_range.start for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA and name in e.name]
    return (sum(spans) / len(spans), len(spans) / reps) if spans else None


def _launch_text(prof):
    if prof is None:
        return "no device activity recorded"
    return f"{prof[0]:.1f} us a launch, {prof[1]:.1f} launches a call (profiler)"


def _swing_phases(torch, dev, amcx_torch):
    """Phases 15-16: kernel 10 (``lsmc_swing``) against its plain version and
    kernel 2, then the swing route and the volume contract at full width.
    Returns the kernel's row numbers and its bound."""
    from amcx_torch.ops.gbm import gbm_paths
    from amcx_torch.ops.lsmc_megakernel import lsmc_price_megakernel
    from amcx_torch.ops.lsmc_swing import (SWING_MAX_RIGHTS, lsmc_price_swing,
                                           lsmc_price_swing_reference)

    market = amcx_torch.MarketParams(S0, SW_R, SW_SIGMA)
    steps_c = SW_CONTRACT_STEPS
    paths_a = gbm_paths(SEED + 50, S0, SW_R, SW_SIGMA, 0.0, T, N_STEPS, N_PATHS, device=dev)
    frame_a = dict(zip(("mean_t", "inv_std_t"),
                       amcx_torch.gbm_standardization(market, T, N_STEPS, device=dev)))
    frame_c = dict(zip(("mean_t", "inv_std_t"),
                       amcx_torch.gbm_standardization(market, T, steps_c, device=dev)))
    paths_c = amcx_torch.simulate_gbm(SEED + 51, market, T, amcx_torch.SimConfig(
        n_paths=N_PATHS, n_steps=steps_c, antithetic=True), dev)
    paths_d = gbm_paths(SEED + 52, S0, SW_R, SW_SIGMA, 0.0, T, steps_c, N_PATHS, device=dev)
    curve = torch.tensor([0.03] * (N_STEPS // 2) + [0.08] * (N_STEPS // 2), device=dev)
    dt_a, dt_c = T / N_STEPS, T / steps_c
    cases = {
        "(a) 3 rights, put K=105, ITM, degree 4, 1M x 100":
            ((paths_a, SW_K, SW_R, dt_a, -1.0, SW_RIGHTS), dict(itm_weights=True, **frame_a)),
        "(b) 1 right, as (a)":
            ((paths_a, SW_K, SW_R, dt_a, -1.0, 1), dict(itm_weights=True, **frame_a)),
        "(c) forward 3 rights, 2 owed, degree 5, antithetic torch paths 1M x 20":
            ((paths_c, 100.0, SW_R, dt_c, -1.0, 3),
             dict(degree=5, payoff_kind="forward", n_min=2, antithetic=True, **frame_c)),
        "(d) forward 11 rights, 3 owed (the contract's up-swing), degree 5, 1M x 20":
            ((paths_d, 100.0, SW_R, dt_c, -1.0, 11),
             dict(degree=5, payoff_kind="forward", n_min=3, **frame_c)),
        "(e) 2 rights under a two-regime rate curve (3% then 8%), as (a)":
            ((paths_a, SW_K, curve, dt_a, -1.0, 2), dict(itm_weights=True, **frame_a)),
    }
    err = 0.0
    for case, (args, kw) in cases.items():
        before = lsmc_price_swing.launches
        ker = lsmc_price_swing(*args, **kw)
        again = lsmc_price_swing(*args, **kw)
        ref = lsmc_price_swing_reference(*args, **kw)
        torch.cuda.synchronize()
        n_launch = lsmc_price_swing.launches - before
        diffs = [abs(float(a) - float(b)) for a, b in zip(ker, ref)]
        same = all(torch.equal(a, b) for a, b in zip(ker, ref))
        rerun = all(torch.equal(a, b) for a, b in zip(ker, again))
        line = (f"phase 15 swing kernel {case}: price {float(ker[0]):.6f} stderr "
                f"{float(ker[1]):.6f} | kernel vs plain max|d| price {diffs[0]:.3e} stderr "
                f"{diffs[1]:.3e} | equal to plain {same} | bit-identical rerun {rerun} | "
                f"launches {n_launch}")
        _require(math.isfinite(float(ker[0])) and float(ker[1]) > 0,
                 f"swing {case}: finite price, positive stderr")
        _require(n_launch == 2, f"swing {case}: launches {n_launch}")
        _require(same, f"swing {case}: kernel equal to its plain version {diffs}")
        _require(rerun, f"swing {case}: two kernel runs bit-identical")
        if case.startswith("(b)"):
            single = lsmc_price_megakernel(paths_a, SW_K, SW_R, dt_a, -1.0, itm_weights=True,
                                           return_stats=True, **frame_a)
            torch.cuda.synchronize()
            k2_same = all(torch.equal(a, b) for a, b in zip(ker, single))
            line += (f" | kernel 2 {float(single[0]):.6f} stderr {float(single[1]):.6f} "
                     f"equal {k2_same}")
            _require(k2_same, "one-right swing equal to kernel 2 on the same paths and frame")
        print(line, flush=True)
        err = max(err, *diffs)
    # the rights cap: at the cap the kernel equals its plain version; above
    # it the wrapper raises
    cap_paths = paths_d[:9, :65_536].contiguous()
    cap_kw = dict(degree=10, payoff_kind="forward", n_min=3)
    cap_ker = lsmc_price_swing(cap_paths, 100.0, SW_R, dt_c, -1.0, SWING_MAX_RIGHTS, **cap_kw)
    cap_ref = lsmc_price_swing_reference(cap_paths, 100.0, SW_R, dt_c, -1.0, SWING_MAX_RIGHTS,
                                         **cap_kw)
    torch.cuda.synchronize()
    cap_same = all(torch.equal(a, b) for a, b in zip(cap_ker, cap_ref))
    try:
        lsmc_price_swing(cap_paths, 100.0, SW_R, dt_c, -1.0, SWING_MAX_RIGHTS + 1)
        cap_raises = False
    except ValueError:
        cap_raises = True
    print(f"phase 15 rights cap {SWING_MAX_RIGHTS} (degree 10, 65536 x 8): price "
          f"{float(cap_ker[0]):.5f} equal to plain {cap_same} | {SWING_MAX_RIGHTS + 1} rights "
          f"raises {cap_raises}", flush=True)
    _require(cap_same and cap_raises, "the swing kernel at its rights cap")
    args_a, kw_a = cases["(a) 3 rights, put K=105, ITM, degree 4, 1M x 100"]
    ms = _time_ms(torch, lambda: lsmc_price_swing(*args_a, **kw_a), 20, 3)
    plain_ms = _time_ms(torch, lambda: lsmc_price_swing_reference(*args_a, **kw_a), 3, 1)
    print(f"phase 15 kernel 10 on (a): {ms:.3f} ms, plain {plain_ms:.3f} ms", flush=True)
    prof10 = _profile(torch, lambda: lsmc_price_swing(*args_a, **kw_a), 3)
    per_step = prof10 and {name: us / N_STEPS for name, us in prof10["top_us_per_call"].items()}
    # the moments' floors per step: S_t and the SW_RIGHTS planes read once,
    # and one f32 -> f64 conversion of each of the P = 15 + 5 R products
    floor10 = {"bytes_us": bound_s({"bytes": (SW_RIGHTS + 1) * N_PATHS * 4}) * 1e6,
               "conversions_us": N_PATHS * (15 + 5 * SW_RIGHTS) / F64_CONVERSIONS_PER_S * 1e6}
    print(f"phase 15 kernel 10 on (a), device time per step by kernel (us): "
          f"{per_step or 'no device activity recorded'} | moments' design floors per step "
          f"(us): {floor10}", flush=True)
    del paths_c, cap_paths

    # ---- phase 16: the swing route at full width -------------------------
    product = amcx_torch.ProductSpec(K=SW_K, T=T, option_type="put", exercise="american")
    spec = amcx_torch.RegressionSpec(degree=4)
    sim = amcx_torch.SimConfig(n_paths=N_PATHS, n_steps=N_STEPS, backend="philox")

    def pricing(seed=SEED + 60):
        return amcx_torch.price_swing_option(seed, market, product, SW_RIGHTS, spec, sim,
                                             engine="mega", device=dev)

    lattice = amcx_torch.crr_swing_price(S0, SW_K, T, SW_R, SW_SIGMA, SW_RIGHTS,
                                         n_steps=N_STEPS, n_sub=20)
    torch.cuda.synchronize()
    gbm_paths.launches = lsmc_price_swing.launches = 0
    res = pricing()
    torch.cuda.synchronize()
    launches = {"gbm_paths": gbm_paths.launches, "lsmc_swing": lsmc_price_swing.launches}
    price, stderr = float(res.price), float(res.stderr)
    _require(all(n > 0 for n in launches.values()), f"swing route launched {launches}")
    _require(abs(price - lattice) <= 4 * stderr + 0.02,
             f"swing |price - lattice| = {abs(price - lattice):.5f} <= 4*{stderr:.5f} + 0.02")
    seeds = iter(range(SEED + 61, SEED + 1000))
    route_ms = _time_ms(torch, lambda: pricing(next(seeds)).price, 20, 3)
    prof = _profile(torch, lambda: pricing(), 3)
    print(f"phase 16 swing route {N_PATHS}x{N_STEPS}, {SW_RIGHTS} rights (put K={SW_K}): price "
          f"{price:.5f} stderr {stderr:.5f} rights lattice {lattice:.5f} |err| "
          f"{abs(price - lattice):.5f} | launches {launches} | {route_ms:.3f} ms/pricing "
          f"(median of 20) | profile {prof or 'no device activity recorded'}", flush=True)

    c_sim = amcx_torch.SimConfig(n_paths=N_PATHS, n_steps=steps_c, backend="philox")
    gbm_paths.launches = lsmc_price_swing.launches = 0
    contract = amcx_torch.price_swing_contract(SEED + 70, market, spec=amcx_torch.RegressionSpec(
        degree=5), sim=c_sim, engine="mega", device=dev, **SW_CONTRACT)
    torch.cuda.synchronize()
    c_launches = {"gbm_paths": gbm_paths.launches, "lsmc_swing": lsmc_price_swing.launches}
    up_lattice = amcx_torch.crr_swing_price(S0, 100.0, T, SW_R, SW_SIGMA, contract.m_max,
                                            n_steps=steps_c, n_sub=25, option_type="put",
                                            payoff_kind="forward", n_min=contract.m_min)
    dq = SW_CONTRACT["q_take_max"] - SW_CONTRACT["q_take_min"]
    composed = SW_CONTRACT["q_take_min"] * contract.strip_value + dq * up_lattice
    c_err = abs(contract.price - composed)
    _require((contract.m_min, contract.m_max) == (3, 11), f"contract m {contract}")
    _require(all(n > 0 for n in c_launches.values()), f"contract route launched {c_launches}")
    _require(c_err <= 3.5 * contract.stderr + 0.02,
             f"contract |price - composed lattice| = {c_err:.5f} <= 3.5*{contract.stderr:.5f}"
             f" + 0.02")
    print(f"phase 16 JRT contract (take in [0.5, 1], total in [12, 16], {N_PATHS}x{steps_c}): "
          f"price {contract.price:.5f} stderr {contract.stderr:.5f} = 0.5 strip "
          f"{contract.strip_value:.5f} + 0.5 up-swing {contract.upswing_value:.5f} (m in "
          f"[{contract.m_min}, {contract.m_max}]) | composed lattice {composed:.5f} |err| "
          f"{c_err:.5f} | launches {c_launches}", flush=True)

    # kernel 10 on (a): reads the paths once; per path-step the P = 30 pair
    # products (f32) and their f64 sums, R fitted continuations of 2k - 1
    # operations and the cascade's 4 operations per right
    k, P = 5, 15 + 5 * SW_RIGHTS
    bound = _bound((N_STEPS + 1) * N_PATHS * 4 + 4 * (N_STEPS + 1) * 4,
                   f32_ops=N_STEPS * N_PATHS * (P + SW_RIGHTS * (2 * k - 1) + 4 * SW_RIGHTS),
                   f64_ops=N_STEPS * N_PATHS * P)
    return dict(launches=launches["lsmc_swing"], max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound=bound)


def _qmc_phases(torch, dev, amcx_torch, sass):
    """Phases 17-18: kernel 11 (``sobol_gbm``) against its plain version and
    scipy's point set, then the QMC route into kernel 2 on the flagship put.
    Returns the kernel's row numbers and bound in each order."""
    import numpy as np
    from scipy.stats import norm, qmc

    from amcx_torch.ops.lsmc_megakernel import lsmc_price_megakernel
    from amcx_torch.ops.sobol_pallas import (BRIDGE_MAX_STEPS, _bits_to_uniform,
                                             _bridge_schedule, _direction_tables, _in_tail,
                                             sobol_gbm_paths, sobol_gbm_paths_reference,
                                             sobol_tables)

    seed = 2026
    args = (seed, S0, R, SIGMA, 0.0, T, N_STEPS, N_PATHS)
    err, ms, plain_ms, device_us = {}, {}, {}, {}
    # the main path's shape in both orders, then the bridge order at 20 steps
    # and at its cap (131,072 paths: the plain version's dense product)
    for mode, bridge, n_steps, n_paths in (("increment", False, N_STEPS, N_PATHS),
                                           ("bridge", True, N_STEPS, N_PATHS),
                                           ("bridge", True, 20, N_PATHS),
                                           ("bridge", True, BRIDGE_MAX_STEPS, 131_072)):
        case_args = args[:6] + (n_steps, n_paths)
        before = sobol_gbm_paths.launches
        ker = sobol_gbm_paths(*case_args, brownian_bridge=bridge, device=dev)
        again = sobol_gbm_paths(*case_args, brownian_bridge=bridge, device=dev)
        ref = sobol_gbm_paths_reference(*case_args, brownian_bridge=bridge, device=dev)
        torch.cuda.synchronize()
        n_launch = sobol_gbm_paths.launches - before
        d = float(torch.max(torch.abs(ker - ref)))
        same, rerun = torch.equal(ker, ref), torch.equal(ker, again)
        case = f"{mode} order {n_paths}x{n_steps}"
        _require(tuple(ker.shape) == (n_steps + 1, n_paths) and bool(torch.isfinite(ker).all()),
                 f"sobol {case}: shape and finite")
        _require(n_launch == 2, f"sobol {case}: launches {n_launch}")
        _require(same, f"sobol {case}: kernel equal to its plain version (max|dS| {d:.3e})")
        _require(rerun, f"sobol {case}: two kernel runs bit-identical")
        err[mode] = max(err.get(mode, 0.0), d)
        if not bridge:
            # the first 4096 points of scipy's scrambled engine (Gray-code
            # order k, natural index k ^ (k >> 1)): the tables hold the same
            # 30-bit integers, the f32 uniforms their leading 23 bits, and
            # the kernel's increments invert to them
            u_hi, u_lo = _direction_tables(seed, N_STEPS, N_PATHS)
            kk = np.arange(4096)
            nat = kk ^ (kk >> 1)
            pts = u_hi[:, nat >> 9] ^ u_lo[:, nat & 511]
            ref_u = qmc.Sobol(d=N_STEPS, scramble=True, seed=seed).random(4096).T
            ints_equal = bool(np.array_equal(pts * 2.0 ** -30, ref_u))
            u32 = _bits_to_uniform(torch.from_numpy(pts.view(np.int32))).numpy()
            trunc = float(np.abs(u32.astype(np.float64) - ref_u).max())
            S = ker[:, torch.from_numpy(nat).to(dev)].double().cpu().numpy()
            dt = T / N_STEPS
            z_hat = ((np.log(S[1:]) - np.log(S[:-1]) - np.float32((R - 0.5 * SIGMA ** 2) * dt))
                     / float(np.float32(SIGMA) * np.sqrt(np.float32(dt))))
            u_err = float(np.abs(norm.cdf(z_hat) - ref_u).max())
            print(f"phase 17 Sobol point set vs scipy Sobol(d={N_STEPS}, scramble=True, "
                  f"seed={seed}), first 4096 points: integers equal {ints_equal} | f32 uniform "
                  f"max|d| {trunc:.3e} (2^-24 = {2.0 ** -24:.3e}) | kernel increments "
                  f"inverted max|d| {u_err:.3e}", flush=True)
            _require(ints_equal and trunc <= 2.0 ** -24 and u_err <= 1e-4,
                     "Sobol point set equal to scipy's to f32 truncation")
        timing = ""
        if n_steps == N_STEPS:
            ms[mode] = _time_ms(torch, lambda b=bridge: sobol_gbm_paths(
                *args, brownian_bridge=b, device=dev), 20, 3)
            plain_ms[mode] = _time_ms(torch, lambda b=bridge: sobol_gbm_paths_reference(
                *args, brownian_bridge=b, device=dev), 3, 1)
            prof = _kernel_us(torch, lambda b=bridge: sobol_gbm_paths(
                *args, brownian_bridge=b, device=dev), 10,
                "sobol_bridge_kernel" if bridge else "sobol_increment_kernel")
            device_us[mode] = prof and prof[0]
            timing = (f" | {ms[mode]:.3f} ms, plain {plain_ms[mode]:.3f} ms | device "
                      f"{_launch_text(prof)}")
        print(f"phase 17 Sobol kernel {case}: kernel vs plain max|dS| {d:.3e} | equal to plain "
              f"{same} | bit-identical rerun {rerun} | launches {n_launch}{timing}", flush=True)
        del ker, again, ref

    # ---- phase 18: the QMC route at full width ---------------------------
    market = amcx_torch.MarketParams(S0, R, SIGMA)
    sim = amcx_torch.SimConfig(n_paths=N_PATHS, n_steps=N_STEPS)
    mean_t, inv_std_t = amcx_torch.gbm_standardization(market, T, N_STEPS, device=dev)
    crr = amcx_torch.crr_price(S0, STRIKE, T, R, SIGMA, 2000, option_type="put", american=True)
    bs = amcx_torch.bs_price(S0, STRIKE, T, R, SIGMA, option_type="put")

    def route(qseed, bridge):
        paths = amcx_torch.simulate_gbm_qmc_device(qseed, market, T, sim,
                                                   brownian_bridge=bridge, device=dev)
        out = lsmc_price_megakernel(paths, STRIKE, R, T / N_STEPS, -1.0, itm_weights=True,
                                    mean_t=mean_t, inv_std_t=inv_std_t, return_stats=True)
        return paths, out

    runs, launches = {}, {}
    for bridge in (False, True):  # each order's launches counted on their own
        torch.cuda.synchronize()
        sobol_gbm_paths.launches = lsmc_price_megakernel.launches = 0
        runs[bridge] = route(seed + 1, bridge)
        torch.cuda.synchronize()
        launches[bridge] = {"sobol_gbm": sobol_gbm_paths.launches,
                            "lsmc_mega": lsmc_price_megakernel.launches}
        _require(all(n > 0 for n in launches[bridge].values()),
                 f"QMC route (bridge={bridge}) launched {launches[bridge]}")
    for bridge, (paths, (price, stderr)) in runs.items():
        mode = "bridge" if bridge else "increment"
        euro = math.exp(-R * T) * float(torch.clamp_min(STRIKE - paths[-1].double(), 0.0).mean())
        p_err = abs(float(price) - crr)
        _require(p_err <= QMC_CRR_TOL, f"QMC {mode} |price - CRR-2000| {p_err:.5f} <= "
                                       f"{QMC_CRR_TOL}")
        if bridge:
            _require(abs(euro - bs) <= QMC_BS_TOL,
                     f"QMC bridge European |err| {abs(euro - bs):.5f} <= {QMC_BS_TOL}")
        seeds = iter(range(seed + 10 + 100 * bridge, seed + 1000))  # no cached tables
        route_ms = _time_ms(torch, lambda b=bridge: route(next(seeds), b)[1][0], 5, 1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sobol_tables(seed + 999, N_STEPS, N_PATHS, dev)
        torch.cuda.synchronize()
        tables_ms = (time.perf_counter() - t0) * 1e3
        print(f"phase 18 QMC route {mode} order {N_PATHS}x{N_STEPS} American put: price "
              f"{float(price):.5f} (MC stderr formula {float(stderr):.5f}) CRR-2000 {crr:.5f} "
              f"|err| {p_err:.5f} | European {euro:.5f} Black-Scholes {bs:.5f} |err| "
              f"{abs(euro - bs):.5f} | launches {launches[bridge]} | route {route_ms:.3f} "
              f"ms (median of 5, a new seed each: its direction tables built on the card, "
              f"{tables_ms:.3f} ms on their own to a synchronise, included)", flush=True)
    del runs

    # kernel 11 writes the (T+1, n) paths and reads the two tables; per
    # path-step ~62 f32 operations (Acklam's two rational forms, log, sqrt,
    # the uniform, the running sum, exp, the S0 product). The bridge order
    # adds its schedule's bytes and the 2 nnz(B) / n_steps operations a
    # path-step of the bridge product (the dense count, 2 n_steps, is work
    # the function does not need)
    table_bytes = N_STEPS * (N_PATHS // 512) * 4 + N_STEPS * 512 * 4
    _, entries, _ = _bridge_schedule(N_STEPS, T)
    nnz = len(entries)
    bound = {"increment": _bound((N_STEPS + 1) * N_PATHS * 4 + table_bytes,
                                 f32_ops=62 * N_STEPS * N_PATHS),
             "bridge": _bound((N_STEPS + 1) * N_PATHS * 4 + table_bytes + nnz * 8
                              + (N_STEPS + 1) * 4, f32_ops=(62 * N_STEPS + 2 * nnz) * N_PATHS)}
    per, weights = {"increment": None, "bridge": None}, ""
    inc, br = sass.get("sobol_gbm"), sass.get("sobol_gbm_bridge")
    if inc is not None and N_STEPS % INC_CHUNK_STEPS == 0:
        # this run's tail points (seed, N_STEPS x N_PATHS), per thread and
        # chunk: thread `lane` of warp w of block b runs the paths b*512 +
        # 128 w + 4 lane + k. A warp passes through the compaction loop as
        # often as its busiest lane has tail points, and through the dense
        # loop floor(ceil(tail points / 32) / tail_points) times
        n_blocks = N_PATHS // 512
        u_hi, u_lo = (torch.from_numpy(t.view(np.int32).copy()).to(dev)
                      for t in _direction_tables(seed, N_STEPS, N_PATHS))
        tail = _in_tail(_bits_to_uniform(torch.bitwise_xor(
            u_hi.repeat_interleave(512, dim=1), u_lo.repeat(1, n_blocks))))
        per_thread = tail.view(N_STEPS // INC_CHUNK_STEPS, INC_CHUNK_STEPS, n_blocks, 4, 32,
                               INC_PATHS).sum(dim=(1, 5))
        passes = float(per_thread.amax(dim=-1).double().mean())
        rounds = float((((per_thread.sum(dim=-1) + 31) // 32) // inc["tail_points"])
                       .double().mean())
        per["increment"] = (inc["chunk"] + inc["compaction"] * passes + inc["tail"] * rounds) / (
            INC_CHUNK_STEPS * INC_PATHS)
        weights += (f"increment: tail points {float(tail.double().mean()):.5f} of all, "
                    f"compaction passes {passes:.4f} and dense passes {rounds:.5f} a warp-chunk")
        del u_hi, u_lo, tail, per_thread
    if br is not None:
        # each row's loop once, its born entries (one a Sobol dimension) and
        # the other nonzeros of B, for the 4 paths of a thread
        n_born = int((entries[:, 0] < 0).sum())
        per["bridge"] = (br["row"] * N_STEPS + br["born"] * n_born
                         + br["other"] * (nnz - n_born)) / (N_STEPS * BRIDGE_PATHS)
        weights += f"; bridge: {n_born} born of {nnz} entries"
    floor = {mode: _issue_floor_ms(per[mode], N_STEPS * N_PATHS) for mode in bound}
    print(f"phase 17 bounds: increment {bound['increment'][0]:.4f} ms "
          f"({bound['increment'][1]}), bridge {bound['bridge'][0]:.4f} ms "
          f"({bound['bridge'][1]}; nnz(B) {nnz} of {N_STEPS ** 2}) | design floors (issue) "
          f"increment {_floor_text(floor['increment'], per['increment'])}, bridge "
          f"{_floor_text(floor['bridge'], per['bridge'])} | this run's data ({weights}) | "
          f"kernel ms {ms} device us {device_us} plain ms {plain_ms}", flush=True)
    return {mode: dict(launches=launches[mode == "bridge"]["sobol_gbm"], max_abs_err=err[mode],
                       ms=ms[mode], plain_ms=plain_ms[mode], bound=bound[mode],
                       device_us=device_us[mode], design_floor_ms=floor[mode])
            for mode in ("increment", "bridge")}


def _ccr_phase(torch, dev, amcx_torch):
    """Phase 19: the CCR exposure kernel (``csrc/ccr_exposures.cu``) against
    its plain version on the flagship put's paths and kernel 2's all-paths
    coefficients at 1M x 100, its time beside its bound and design floor,
    then ``price_option(engine="mega", surface_stats=True)`` (kernel 1,
    kernel 2 and the exposure kernel launched once each; the price and
    stderr bits of the call without the profile). Returns the kernel's row,
    its ``launches`` that pricing's count."""
    from amcx_torch.ops import ccr_exposures as ccr
    from amcx_torch.ops.gbm import gbm_paths
    from amcx_torch.ops.lsmc_megakernel import lsmc_price_megakernel

    market = amcx_torch.MarketParams(S0, R, SIGMA)
    paths = gbm_paths(SEED, S0, R, SIGMA, 0.0, T, N_STEPS, N_PATHS, device=dev)
    mean_t, inv_std_t = amcx_torch.gbm_standardization(market, T, N_STEPS, device=dev)
    coeffs = lsmc_price_megakernel(paths, STRIKE, R, T / N_STEPS, -1.0, itm_weights=False,
                                   mean_t=mean_t, inv_std_t=inv_std_t, return_coeffs=True).coeffs

    def kernel():
        return ccr.ccr_exposures(paths, coeffs, mean_t, inv_std_t)

    rows = kernel()
    ref = ccr.ccr_exposures_reference(paths, coeffs, mean_t, inv_std_t)
    err = float(torch.max(torch.abs(rows - ref)))
    _require(torch.equal(rows.view(torch.int32), ref.view(torch.int32)),
             f"ccr_exposures kernel equal to its plain version (max|d| {err:.3e})")
    ms = _time_ms(torch, kernel, 20, 3)
    ms_plain = _time_ms(torch, lambda: ccr.ccr_exposures_reference(paths, coeffs, mean_t,
                                                                   inv_std_t), 3, 1)
    prof = _profile(torch, kernel, 10)
    # reads the paths of the 100 dates before maturity once; per path-step
    # the fit's 21 f32 operations (Chebyshev degree 4) and EPE's f64 add
    path_steps = N_STEPS * N_PATHS
    bound = _bound(4 * path_steps, f32_ops=21 * path_steps, f64_ops=path_steps)
    # the design floor: the window pass's read and the sample's 1/32 of it
    floor_ms = bound_s({"bytes": 4 * path_steps * (1 + 1 / 32)}) * 1e3
    print(f"phase 19 ccr_exposures kernel (EPE/PFE-5/PFE-95, {N_PATHS}x{N_STEPS}): equal to "
          f"plain | kernel {ms:.4f} ms plain {ms_plain:.3f} ms | device "
          f"{prof or 'no device activity recorded'} | bound {bound[0]:.4f} ms ({bound[1]}), "
          f"design floor {floor_ms:.4f} ms", flush=True)
    del paths, rows, ref

    args = (SEED, market, amcx_torch.ProductSpec(K=STRIKE, T=T, option_type="put",
                                                 exercise="american"),
            amcx_torch.RegressionSpec(degree=4, regress_on="all"),
            amcx_torch.SimConfig(n_paths=N_PATHS, n_steps=N_STEPS, backend="philox"))

    def route(**kw):
        return amcx_torch.price_option(*args, engine="mega", device=dev, **kw)

    # the main path: kernel 1, kernel 2 and the exposure kernel once each
    torch.cuda.synchronize()
    gbm_paths.launches = lsmc_price_megakernel.launches = ccr.ccr_exposures.launches = 0
    res = route(surface_stats=True)
    torch.cuda.synchronize()
    launches = {"gbm_paths": gbm_paths.launches, "lsmc_mega": lsmc_price_megakernel.launches,
                "ccr_exposures": ccr.ccr_exposures.launches}
    _require(launches == dict(gbm_paths=1, lsmc_mega=1, ccr_exposures=1),
             f"the profile's route launched each kernel once {launches}")
    plain = route()
    e = res.exposures
    _require(torch.equal(res.price, plain.price) and torch.equal(res.stderr, plain.stderr),
             "the profile keeps the price and stderr bits")
    _require(bool(torch.isfinite(torch.stack([e.epe, e.pfe5, e.pfe95])).all()),
             "a finite profile")
    ms_route = _time_ms(torch, lambda: route(surface_stats=True), 10, 2)
    ms_price = _time_ms(torch, route, 10, 2)
    print(f"phase 19 price_option(engine='mega', surface_stats=True) {N_PATHS}x{N_STEPS}: price "
          f"{float(res.price):.6f} +- {float(res.stderr):.6f}, EPE t=50 {float(e.epe[50]):.4f} "
          f"PFE-5 {float(e.pfe5[50]):.4f} PFE-95 {float(e.pfe95[50]):.4f} | {ms_route:.3f} ms, "
          f"{ms_price:.3f} ms without the profile | launches {launches}", flush=True)
    return {"launches": launches["ccr_exposures"], "max_abs_err": err, "ms": ms,
            "plain_ms": ms_plain, "device_us": prof and prof["device_us_per_call"],
            "design_floor_ms": floor_ms, "bound": bound}


def _rqmc_phase(torch, dev, amcx_torch):
    """Phase 20: randomized-QMC pricing through the public entry,
    ``price_option(engine="mega")`` with ``SimConfig(backend="sobol-bridge")``
    on the flagship put at 1M x 100: one pricing on a new seed builds its
    tables once on the card (one launch of the table kernel, no
    host-to-device copy) and launches kernel 11 and kernel 2 once each; the
    same seed again builds nothing, copies nothing to the card and gives the
    same bits. Prints the price against CRR-2000, the table kernel's device
    µs, and the times of a pricing on a new seed (host clock, values on the
    host), of the ``pathgen.tables`` span, and of a pricing on a cached
    seed."""
    from torch.profiler import ProfilerActivity, profile

    from amcx_torch import tracing
    from amcx_torch.ops.lsmc_megakernel import lsmc_price_megakernel
    from amcx_torch.ops.sobol_pallas import sobol_gbm_paths, sobol_tables

    market = amcx_torch.MarketParams(S0, R, SIGMA)
    product = amcx_torch.ProductSpec(K=STRIKE, T=T, option_type="put", exercise="american")
    spec = amcx_torch.RegressionSpec(degree=4)
    sim = amcx_torch.SimConfig(n_paths=N_PATHS, n_steps=N_STEPS, backend="sobol-bridge")
    crr = amcx_torch.crr_price(S0, STRIKE, T, R, SIGMA, 2000, option_type="put", american=True)

    def pricing(seed):
        res = amcx_torch.price_option(seed, market, product, spec, sim, engine="mega", device=dev)
        return torch.stack([res.price, res.stderr]).tolist()

    seed = SEED + 7000
    pricing(seed - 1)  # the bridge schedule and the frame rows, once per grid
    torch.cuda.synchronize()

    def counts():
        return (sobol_gbm_paths.launches, lsmc_price_megakernel.launches,
                sobol_gbm_paths.table_builds, sobol_tables.launches)

    before = counts()
    first = pricing(seed)
    new = [b - a for a, b in zip(before, counts())]
    _require(new == [1, 1, 1, 1], f"RQMC pricing on a new seed: kernel 11, kernel 2, table "
                                  f"builds and table kernels {new} (want 1, 1, 1, 1)")
    builds = sobol_gbm_paths.table_builds
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        again = pricing(seed)
        torch.cuda.synchronize()
    h2d = [e.name for e in prof.events() if "HtoD" in e.name]
    _require(sobol_gbm_paths.table_builds == builds and not h2d,
             f"RQMC pricing on a cached seed: table builds {sobol_gbm_paths.table_builds - builds}"
             f", host-to-device copies {h2d}")
    _require(again == first, "RQMC pricing on a cached seed: the same bits")
    # new seeds under the profiler (which may drop the first launches of a
    # window): no host-to-device copy, and the table kernel's device time
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for s in range(seed + 100, seed + 110):
            pricing(s)
        torch.cuda.synchronize()
    h2d = [e.name for e in prof.events() if "HtoD" in e.name]
    _require(not h2d, f"RQMC pricing on a new seed: host-to-device copies {h2d}")
    table_us = [e.time_range.end - e.time_range.start for e in prof.events()
                if e.device_type == torch.autograd.DeviceType.CUDA
                and "sobol_tables_kernel" in e.name]
    table_text = (f"{statistics.median(table_us):.1f} us a launch ({len(table_us)} of 10 "
                  f"recorded)" if table_us else "no device activity recorded")
    p_err = abs(first[0] - crr)
    _require(p_err <= QMC_CRR_TOL, f"RQMC |price - CRR-2000| {p_err:.5f} <= {QMC_CRR_TOL}")

    def host_ms(seeds):
        times = []
        for s in seeds:
            t0 = time.perf_counter()
            pricing(s)
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times)

    new_ms = host_ms(range(seed + 1, seed + 21))
    tracing.drain()
    with tracing.recording():
        for s in range(seed + 21, seed + 41):
            pricing(s)
    tables_ms = statistics.median((sp.end_ns - sp.start_ns) * 1e-6 for sp in tracing.drain()
                                  if sp.name == "pathgen.tables")
    cached_ms = host_ms([seed] * 20)
    print(f"phase 20 RQMC price_option(engine='mega', backend='sobol-bridge') {N_PATHS}x"
          f"{N_STEPS} American put: price {first[0]:.5f} (MC stderr formula {first[1]:.5f}) "
          f"CRR-2000 {crr:.5f} |err| {p_err:.5f} | new seed: kernel 11, kernel 2, table "
          f"builds, table kernels {new}, 0 host-to-device copies, table kernel "
          f"{table_text} | cached seed: 0 builds, 0 host-to-device "
          f"copies, same bits | ms a pricing "
          f"(median of 20, host clock to the values on the host): new seed {new_ms:.3f}, "
          f"pathgen.tables span {tables_ms:.3f}, cached seed {cached_ms:.3f}", flush=True)


def main():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; this needs a CUDA card")

    import amcx_torch
    from amcx_torch.engine_pallas import (backward_induction_fused,
                                          backward_induction_fused_reference)
    from amcx_torch.ops import _build
    from amcx_torch.ops.gbm import gbm_paths, gbm_paths_reference
    from amcx_torch.ops.gbm_multi import gbm_multi_paths, gbm_multi_paths_reference
    from amcx_torch.ops.lsmc_megakernel import (lsmc_book_mega_reference,
                                                lsmc_book_megakernel,
                                                lsmc_price_mega_reference,
                                                lsmc_price_megakernel)
    from amcx_torch.ops.lsmc_pallas import (step_apply, step_apply_reference, step_moments,
                                            step_moments_reference, step_stats, unpack_moments)
    from amcx_torch.models.maxcall import (backward_induction_fused_maxcall,
                                           backward_induction_fused_maxcall_reference)
    from amcx_torch.ops import lsmc_ma_mega, maxcall_pallas
    from amcx_torch.ops.lsmc_fusedpath import (fusedpath_paths_reference, lsmc_price_fusedpath,
                                               lsmc_price_fusedpath_reference)
    from amcx_torch.ops.lsmc_ma_mega import lsmc_price_ma_mega, lsmc_price_ma_mega_reference
    from amcx_torch.ops.maxcall_pallas import (ma_step_apply, ma_step_apply_reference,
                                               ma_step_moments, ma_step_moments_reference)

    try:
        import scipy
    except ImportError as exc:
        raise SystemExit("chip_smoke: scipy is missing; the Sobol direction tables and the "
                         "host QMC route need scipy.stats.qmc") from exc

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")

    # ---- phase 1: environment + build ------------------------------------
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip()
    t0 = time.perf_counter()
    _build.libraries()
    build_s = time.perf_counter() - t0
    sass = _sass_model(_build.build_info["paths"])
    print(f"phase 1 env: python {sys.version.split()[0]} torch {torch.__version__} "
          f"scipy {scipy.__version__} cuda {torch.version.cuda} device "
          f"{torch.cuda.get_device_name(0)} count {torch.cuda.device_count()} | {smi} | "
          f"kernels built in "
          f"{build_s:.1f} s ({'compiled' if _build.build_info['built'] else 'cached'}) | "
          f"SASS loop counts {sass}", flush=True)

    market = amcx_torch.MarketParams(S0, R, SIGMA)
    dt = T / N_STEPS
    drift_dt = (R - 0.5 * SIGMA ** 2) * dt
    vol_sdt = SIGMA * math.sqrt(dt)

    # ---- phase 2: kernel 1 (Philox GBM pathgen), at the main path's shape -
    full = gbm_paths(SEED, S0, R, SIGMA, 0.0, T, N_STEPS, N_PATHS, device=dev)
    plain = gbm_paths_reference(SEED, S0, R, SIGMA, 0.0, T, N_STEPS, N_PATHS, device=dev)
    torch.cuda.synchronize()
    _require(tuple(full.shape) == (N_STEPS + 1, N_PATHS), "pathgen shape")
    _require(bool(torch.isfinite(full).all()), "pathgen output finite")
    gbm_err = float(torch.max(torch.abs(full - plain)))
    gbm_rel = float(torch.max(torch.abs(full - plain) / torch.abs(plain)))
    _require(gbm_rel <= 1e-5, f"pathgen kernel vs plain rtol {gbm_rel:.3e} <= 1e-5")
    del plain
    disc_T = math.exp(-R * T) * full[-1].double()
    m_T = float(disc_T.mean())
    se_T = float(disc_T.std()) / math.sqrt(N_PATHS)
    inc = torch.log(full[1:].double() / full[:-1].double())
    n_inc = inc.numel()
    inc_mean, inc_var = float(inc.mean()), float(inc.var())
    se_mean = math.sqrt(inc_var / n_inc)
    fourth = float(((inc - inc_mean) ** 4).mean())
    se_var = math.sqrt(max(fourth - inc_var ** 2, 0.0) / n_inc)
    del disc_T, inc
    _require(abs(m_T - S0) < 4 * se_T, f"|E[e^-rT S_T] - S0| = {abs(m_T - S0):.4g} < 4*{se_T:.4g}")
    _require(abs(inc_mean - drift_dt) < 4 * se_mean,
             f"log-increment mean {inc_mean:.6g} vs {drift_dt:.6g} (4 se {4 * se_mean:.3g})")
    _require(abs(inc_var - vol_sdt ** 2) < 4 * se_var,
             f"log-increment var {inc_var:.6g} vs {vol_sdt ** 2:.6g} (4 se {4 * se_var:.3g})")
    print(f"phase 2 pathgen {N_PATHS}x{N_STEPS}: kernel vs plain max|dS| {gbm_err:.3e} "
          f"max rel {gbm_rel:.3e} | E[e^-rT S_T] {m_T:.5f} "
          f"(se {se_T:.5f}), inc mean {inc_mean:.4e} (want {drift_dt:.4e}, se {se_mean:.2e}), "
          f"inc var {inc_var:.6e} (want {vol_sdt ** 2:.6e}, se {se_var:.2e})", flush=True)
    prof1 = _kernel_us(torch, lambda: gbm_paths(SEED, S0, R, SIGMA, 0.0, T, N_STEPS, N_PATHS,
                                                device=dev), 10, "gbm_paths_kernel")
    device1_us = prof1 and prof1[0]
    # writes the (T+1, n) paths; ~6 f32 operations per path-step (Box-
    # Muller's share, the log-increment multiply-add, the exp)
    bound1 = _bound((N_STEPS + 1) * N_PATHS * 4, f32_ops=6 * N_STEPS * N_PATHS)
    # the step-quad loop runs N_STEPS / 4 times for each 4 paths
    per1 = sass["gbm_paths"]["quad"] / GBM_QUAD_PATH_STEPS if (
        "gbm_paths" in sass and N_STEPS % 4 == 0) else None
    floor1_ms = _issue_floor_ms(per1, N_STEPS * N_PATHS)
    print(f"phase 2 kernel 1 device time {_launch_text(prof1)} | bound {bound1[0]:.4f} ms "
          f"({bound1[1]}) | design floor (issue) {_floor_text(floor1_ms, per1)}", flush=True)

    # ---- phase 3: kernel 2 (LSMC induction) vs its plain version, on the --
    # ---- main path's (n_steps+1, n_paths) paths ------------------------------
    mean_t, inv_std_t = amcx_torch.gbm_standardization(market, T, N_STEPS, device=dev)
    mega_err = 0.0
    for itm, american in ((True, True), (False, True), (True, False)):
        kw = dict(basis="chebyshev", degree=4, american=american, itm_weights=itm,
                  mean_t=mean_t, inv_std_t=inv_std_t, return_coeffs=True)
        ker = lsmc_price_megakernel(full, STRIKE, R, dt, -1.0, **kw)
        again = lsmc_price_megakernel(full, STRIKE, R, dt, -1.0, **kw)
        ref = lsmc_price_mega_reference(full, STRIKE, R, dt, -1.0, **kw)
        torch.cuda.synchronize()
        d_price = abs(float(ker.price) - float(ref.price))
        d_coef = float(torch.max(torch.abs(ker.coeffs - ref.coeffs)))
        c_max = float(torch.max(torch.abs(ref.coeffs)))
        same = (torch.equal(ker.price, again.price) and torch.equal(ker.stderr, again.stderr)
                and torch.equal(ker.coeffs, again.coeffs))
        equal = (torch.equal(ker.price, ref.price) and torch.equal(ker.stderr, ref.stderr)
                 and torch.equal(ker.coeffs, ref.coeffs))
        case = f"itm={itm} american={american}"
        print(f"phase 3 induction {N_PATHS}x{N_STEPS} {case}: kernel {float(ker.price):.6f} "
              f"plain {float(ref.price):.6f} |d| {d_price:.3e} coeffs max|d| {d_coef:.3e} "
              f"(max|c| {c_max:.3e}) stderr {float(ker.stderr):.5f} | equal to plain {equal} | "
              f"bit-identical rerun {same}", flush=True)
        _require(math.isfinite(float(ker.price)), f"{case}: finite price")
        _require(equal, f"{case}: kernel equal to its plain version (price |d| {d_price:.3e}, "
                        f"coeffs |d| {d_coef:.3e})")
        _require(same, f"{case}: two kernel runs bit-identical")
        mega_err = max(mega_err, d_price, d_coef)

    # ---- phase 4: the main path at full width ----------------------------
    product = amcx_torch.ProductSpec(K=STRIKE, T=T, option_type="put", exercise="american")
    spec = amcx_torch.RegressionSpec(basis="chebyshev", degree=4)
    sim = amcx_torch.SimConfig(n_paths=N_PATHS, n_steps=N_STEPS, backend="philox")
    _require(amcx_torch.resolve_regression_spec(spec, product, q=0.0).regress_on == "itm",
             "auto resolves to itm")
    crr = amcx_torch.crr_price(S0, STRIKE, T, R, SIGMA, 2000, option_type="put", american=True)

    def pricing(seed=SEED):
        return amcx_torch.price_option(seed, market, product, spec, sim, engine="mega",
                                       device=dev)

    torch.cuda.synchronize()
    gbm_paths.launches = 0
    lsmc_price_megakernel.launches = 0
    res = pricing()
    torch.cuda.synchronize()
    launches = {"gbm_paths": gbm_paths.launches, "lsmc_mega": lsmc_price_megakernel.launches}
    price, stderr = float(res.price), float(res.stderr)
    _require(all(n > 0 for n in launches.values()), f"main path launched every kernel {launches}")
    _require(math.isfinite(price) and math.isfinite(stderr) and stderr > 0, "finite price/stderr")
    _require(abs(price - crr) <= 4 * stderr + 0.005,
             f"|price - CRR-2000| = {abs(price - crr):.5f} <= 4*{stderr:.5f} + 0.005")

    prices = []
    seeds = iter(range(SEED + 1, SEED + 1000))
    ms_pricing = _time_ms(torch, lambda: prices.append(pricing(next(seeds)).price), 20, 3)
    mean20 = float(torch.stack(prices[3:]).mean())
    ms_gbm = _time_ms(torch, lambda: gbm_paths(SEED, S0, R, SIGMA, 0.0, T, N_STEPS, N_PATHS,
                                               device=dev), 20, 3)
    ms_gbm_plain = _time_ms(torch, lambda: gbm_paths_reference(
        SEED, S0, R, SIGMA, 0.0, T, N_STEPS, N_PATHS, device=dev), 5, 1)
    mkw = dict(basis="chebyshev", degree=4, itm_weights=True, mean_t=mean_t,
               inv_std_t=inv_std_t)
    ms_mega = _time_ms(torch, lambda: lsmc_price_megakernel(full, STRIKE, R, dt, -1.0, **mkw),
                       20, 3)
    ms_mega_plain = _time_ms(torch, lambda: lsmc_price_mega_reference(
        full, STRIKE, R, dt, -1.0, **mkw), 3, 1)
    rate = N_PATHS * N_STEPS / (ms_pricing / 1e3)
    print(f"phase 4 main path {N_PATHS}x{N_STEPS} American put: price {price:.5f} stderr "
          f"{stderr:.5f} CRR-2000 {crr:.5f} |err| {abs(price - crr):.5f} | mean of 20 timed "
          f"pricings {mean20:.5f} |err| {abs(mean20 - crr):.5f} | launches {launches} | "
          f"{ms_pricing:.3f} ms/pricing (median of 20) = {rate:.4e} path-steps/s | "
          f"pathgen kernel {ms_gbm:.3f} ms plain {ms_gbm_plain:.3f} ms | induction kernel "
          f"{ms_mega:.3f} ms plain {ms_mega_plain:.3f} ms", flush=True)
    prof2 = _profile(torch, lambda: lsmc_price_megakernel(full, STRIKE, R, dt, -1.0, **mkw), 5)
    # the design floor: one f32 -> f64 conversion of each of the 20 moment
    # products a path-step
    floor2_ms = N_STEPS * N_PATHS * 20 / F64_CONVERSIONS_PER_S * 1e3
    print(f"phase 4 kernel 2 device time and launches per induction: "
          f"{prof2 or 'no device activity recorded'} | design floor (conversions) "
          f"{floor2_ms:.4f} ms", flush=True)

    # ---- phase 5: kernels 4+5 (fused step kernels) vs their plain versions,
    # ---- through backward_induction_fused on the phase-2 paths ---------------
    spec_itm = amcx_torch.RegressionSpec(basis="chebyshev", degree=4, regress_on="itm")
    spec_all = amcx_torch.RegressionSpec(basis="chebyshev", degree=4, regress_on="all")
    fused_err = 0.0
    for case, fspec, kw in (
            ("ITM American put", spec_itm, {}),
            ("down-in American put H=90 + surface", spec_itm,
             dict(barrier=90.0, return_surface=True)),
            ("all-paths Bermudan put, every 10th step", spec_all,
             dict(exercise_steps=tuple(range(0, N_STEPS, 10))))):
        before = (step_moments.launches, step_apply.launches)
        ker = backward_induction_fused(full, R, dt, STRIKE, -1.0, fspec, **kw)
        again = backward_induction_fused(full, R, dt, STRIKE, -1.0, fspec, **kw)
        torch.cuda.synchronize()
        n_launch = (step_moments.launches - before[0], step_apply.launches - before[1])
        ref = backward_induction_fused_reference(full, R, dt, STRIKE, -1.0, fspec, **kw)
        torch.cuda.synchronize()
        fields = ("price", "stderr", "cashflows", "exercise_times") + (
            ("continuation",) if kw.get("return_surface") else ())
        diffs = {f: float(torch.max(torch.abs(getattr(ker, f) - getattr(ref, f))))
                 for f in fields}
        same_ref = all(torch.equal(getattr(ker, f), getattr(ref, f)) for f in fields)
        same_rerun = all(torch.equal(getattr(ker, f), getattr(again, f)) for f in fields)
        n_ex = int((ker.exercise_times < N_STEPS).sum())
        print(f"phase 5 fused step kernels {N_PATHS}x{N_STEPS} {case}: kernel "
              f"{float(ker.price):.6f} plain {float(ref.price):.6f} stderr "
              f"{float(ker.stderr):.5f} | max|d| {diffs} | early-exercised paths {n_ex} | "
              f"launches (moments, apply) {n_launch} | equal to plain {same_ref} | "
              f"bit-identical rerun {same_rerun}", flush=True)
        _require(math.isfinite(float(ker.price)), f"{case}: finite price")
        _require(n_launch == (2 * N_STEPS, 2 * N_STEPS), f"{case}: launches {n_launch}")
        _require(same_ref, f"{case}: kernels equal to their plain versions {diffs}")
        _require(same_rerun, f"{case}: two kernel runs bit-identical")
        fused_err = max(fused_err, *diffs.values())
        del ker, again, ref

    # one step of each kernel at the main path's width, against its plain
    # version on the same inputs, and timed
    t_mid = N_STEPS // 2
    ones = torch.ones(N_STEPS + 1, device=dev)
    stats = step_stats(mean_t, inv_std_t, ones, ones)
    S_t = full[t_mid]
    cf0 = torch.clamp_min(STRIKE - full[-1], 0.0)
    tau0 = torch.full((N_PATHS,), float(N_STEPS), device=dev)
    mkw = dict(rdt=float(torch.tensor(R * dt)), K=STRIKE, phi=-1.0, basis="chebyshev",
               degree=4, itm_weights=True)
    akw = dict(K=STRIKE, phi=-1.0, basis="chebyshev", degree=4)
    packed = step_moments(stats, t_mid, S_t, cf0, tau0, **mkw)
    packed_plain = step_moments_reference(stats, t_mid, S_t, cf0, tau0, **mkw)
    coeffs = amcx_torch.pinv_solve(*unpack_moments(packed, 5))
    cf_k, tau_k, row_k = cf0.clone(), tau0.clone(), torch.empty_like(cf0)
    cf_p, tau_p, row_p = cf0.clone(), tau0.clone(), torch.empty_like(cf0)
    step_apply(stats, t_mid, coeffs, S_t, cf_k, tau_k, surface=row_k, **akw)
    step_apply_reference(stats, t_mid, coeffs, S_t, cf_p, tau_p, surface=row_p, **akw)
    torch.cuda.synchronize()
    moments_err = float(torch.max(torch.abs(packed - packed_plain)))
    apply_err = max(float(torch.max(torch.abs(a - b)))
                    for a, b in ((cf_k, cf_p), (tau_k, tau_p), (row_k, row_p)))
    _require(moments_err == 0.0, f"step moments kernel vs plain max|d| {moments_err:.3e} == 0")
    _require(apply_err == 0.0, f"step apply kernel vs plain max|d| {apply_err:.3e} == 0")
    ms_moments = _time_ms(torch, lambda: step_moments(stats, t_mid, S_t, cf0, tau0, **mkw), 50, 5)
    ms_moments_plain = _time_ms(torch, lambda: step_moments_reference(
        stats, t_mid, S_t, cf0, tau0, **mkw), 10, 2)
    # the carry converges after the first call: each timed call rewrites
    # the same exercised paths
    ms_apply = _time_ms(torch, lambda: step_apply(stats, t_mid, coeffs, S_t, cf_k, tau_k,
                                                  surface=row_k, **akw), 50, 5)
    ms_apply_plain = _time_ms(torch, lambda: step_apply_reference(
        stats, t_mid, coeffs, S_t, cf_p, tau_p, surface=row_p, **akw), 10, 2)
    n_ex_step = int((tau_k == t_mid).sum())  # the paths each timed apply writes
    # one PyTorch call for the same Gram: A_w^T A of the materialized (n, 5)
    # design matrix, in full f32
    design = amcx_torch.design_matrix((S_t - mean_t[t_mid]) * inv_std_t[t_mid], "chebyshev", 4)
    design_w = design * (STRIKE - S_t > 0.0).to(torch.float32)[:, None]
    ms_moments_lib = _time_ms(torch, lambda: torch.mm(design_w.T, design), 50, 5)
    del design, design_w
    print(f"phase 5 one step t={t_mid} at {N_PATHS} paths: moments kernel vs plain max|d| "
          f"{moments_err:.3e}, apply kernel vs plain max|d| {apply_err:.3e} | moments kernel "
          f"{ms_moments:.4f} ms plain {ms_moments_plain:.4f} ms library A_w^T A "
          f"{ms_moments_lib:.4f} ms | apply kernel {ms_apply:.4f} ms plain {ms_apply_plain:.4f} "
          f"ms ({n_ex_step} paths written)", flush=True)
    # device time per call of each kernel (one launch a call), beside the
    # moments' design floor: one f32 -> f64 conversion of each of the P4
    # products a path
    prof4 = _profile(torch, lambda: step_moments(stats, t_mid, S_t, cf0, tau0, **mkw), 50)
    prof5 = _profile(torch, lambda: step_apply(stats, t_mid, coeffs, S_t, cf_k, tau_k,
                                               surface=row_k, **akw), 50)
    floor4_us = N_PATHS * 20 / F64_CONVERSIONS_PER_S * 1e6
    host5_us = _host_us(torch, lambda: step_apply(stats, t_mid, coeffs, S_t, cf_k, tau_k,
                                                  surface=row_k, **akw), 200)
    # a step that is no exercise date and takes no surface row: the kernel
    # returns before reading a path
    stats_off = step_stats(mean_t, inv_std_t, ones, torch.zeros_like(ones))
    cf_o, tau_o = cf0.clone(), tau0.clone()
    prof5_off = _profile(torch, lambda: step_apply(stats_off, t_mid, coeffs, S_t, cf_o, tau_o,
                                                   **akw), 50)
    torch.cuda.synchronize()
    _require(torch.equal(cf_o, cf0) and torch.equal(tau_o, tau0),
             "step apply on a non-exercise date leaves cf/tau untouched")
    print(f"phase 5 device time per call: kernel 4 (moments) "
          f"{prof4 or 'no device activity recorded'} | kernel 5 (apply) "
          f"{prof5 or 'no device activity recorded'} | kernel 5 host enqueue {host5_us:.2f} us "
          f"a call | kernel 5 on a non-exercise date, no surface row: "
          f"{prof5_off and round(prof5_off['device_us_per_call'], 3)} us | kernel 4 design "
          f"floor (conversions) {floor4_us:.2f} us", flush=True)
    del cf_k, tau_k, row_k, cf_p, tau_p, row_p, cf_o, tau_o

    # ---- phase 6: kernel 2's cf/tau planes vs its plain version ----------
    ckw = dict(basis="chebyshev", degree=4, itm_weights=True, mean_t=mean_t,
               inv_std_t=inv_std_t, return_cf_tau=True)
    ker = lsmc_price_megakernel(full, STRIKE, R, dt, -1.0, **ckw)
    ref = lsmc_price_mega_reference(full, STRIKE, R, dt, -1.0, **ckw)
    torch.cuda.synchronize()
    cf_tau_err = max(float(torch.max(torch.abs(ker.cashflows - ref.cashflows))),
                     float(torch.max(torch.abs(ker.exercise_times - ref.exercise_times))))
    same = all(torch.equal(a, b) for a, b in zip(ker[:4], ref[:4]))
    repriced = float(torch.mean(ker.cashflows.double()
                                * torch.exp(-R * dt * ker.exercise_times.double())))
    n_ex = int((ker.exercise_times < N_STEPS).sum())
    print(f"phase 6 induction cf/tau planes {N_PATHS}x{N_STEPS}: kernel {float(ker.price):.6f} "
          f"plain {float(ref.price):.6f} | cf/tau max|d| {cf_tau_err:.3e} equal {same} | "
          f"early-exercised paths {n_ex} | planes reprice to {repriced:.6f}", flush=True)
    _require(same, f"cf/tau planes equal to the plain version (max|d| {cf_tau_err:.3e})")
    _require(abs(repriced - float(ker.price)) <= 1e-5 * float(ker.price),
             f"planes reprice {repriced:.6f} vs {float(ker.price):.6f}")
    mega_err = max(mega_err, cf_tau_err)
    del ker, ref, full

    # ---- phase 7: the fused engine's path and the Greeks at full width ----
    def fused_pricing(seed=SEED, prod=product):
        return amcx_torch.price_option(seed, market, prod, spec, sim, engine="fused",
                                       device=dev)

    torch.cuda.synchronize()
    for kernel in (gbm_paths, lsmc_price_megakernel, step_moments, step_apply):
        kernel.launches = 0
    res = fused_pricing()
    torch.cuda.synchronize()
    fused_launches = {"gbm_paths": gbm_paths.launches, "lsmc_mega": lsmc_price_megakernel.launches,
                      "lsmc_step_moments": step_moments.launches,
                      "lsmc_step_apply": step_apply.launches}
    f_price, f_se = float(res.price), float(res.stderr)
    _require(all(fused_launches[k] > 0 for k in ("gbm_paths", "lsmc_step_moments",
                                                 "lsmc_step_apply")),
             f"fused path launched its kernels {fused_launches}")
    _require(math.isfinite(f_price) and math.isfinite(f_se) and f_se > 0, "fused finite")
    _require(abs(f_price - crr) <= 4 * f_se + 0.005,
             f"fused |price - CRR-2000| = {abs(f_price - crr):.5f} <= 4*{f_se:.5f} + 0.005")
    print(f"phase 7 fused path {N_PATHS}x{N_STEPS} American put: price {f_price:.5f} stderr "
          f"{f_se:.5f} CRR-2000 {crr:.5f} |err| {abs(f_price - crr):.5f} | launches "
          f"{fused_launches}", flush=True)

    di_prod = amcx_torch.ProductSpec(K=STRIKE, T=T, barrier=90.0, option_type="put",
                                     exercise="american")
    di = fused_pricing(prod=di_prod)
    crr_di = amcx_torch.crr_down_in_price(S0, STRIKE, T, R, SIGMA, 90.0, n_steps=N_STEPS,
                                          option_type="put", american=True)
    di_err = abs(float(di.price) - crr_di)
    eu_prod = amcx_torch.ProductSpec(K=STRIKE, T=T, option_type="put", exercise="european")
    eu = fused_pricing(prod=eu_prod)
    bs = amcx_torch.bs_price(S0, STRIKE, T, R, SIGMA, option_type="put")
    eu_err = abs(float(eu.price) - bs)
    print(f"phase 7 down-in American put H=90: {float(di.price):.5f} stderr "
          f"{float(di.stderr):.5f} CRR-100 barrier tree {crr_di:.5f} |err| {di_err:.5f} | "
          f"European put {float(eu.price):.5f} stderr {float(eu.stderr):.5f} BS {bs:.5f} "
          f"|err| {eu_err:.5f}", flush=True)
    _require(di_err <= 0.2, f"down-in |price - CRR barrier tree| = {di_err:.5f} <= 0.2")
    _require(eu_err <= 4 * float(eu.stderr),
             f"European |price - BS| = {eu_err:.5f} <= 4*{float(eu.stderr):.5f}")

    torch_sim = amcx_torch.SimConfig(n_paths=N_PATHS, n_steps=N_STEPS, backend="torch")
    bsg = amcx_torch.bs_greeks(S0, STRIKE, T, R, SIGMA, option_type="put")
    greeks_ms = {}
    for route, gsim in (("fused", sim), ("fused-ad", torch_sim), ("mega", sim)):
        def greeks_run(route=route, gsim=gsim):
            return amcx_torch.price_and_greeks(SEED, market, eu_prod, spec, gsim, engine=route,
                                               device=dev)

        p, g = greeks_run()
        got = {k: float(g[k]) for k in ("delta", "vega", "rho")}
        greeks_ms[route] = _time_ms(torch, greeks_run, 3, 1)
        print(f"phase 7 Greeks engine={route} European put: price {float(p):.5f} | "
              f"{ {k: round(v, 5) for k, v in got.items()} } vs BS "
              f"{ {k: round(v, 5) for k, v in bsg.items()} } | {greeks_ms[route]:.3f} ms",
              flush=True)
        _require(abs(got["delta"] - bsg["delta"]) <= 5e-3, f"{route}: delta atol 5e-3")
        for k in ("vega", "rho"):
            _require(abs(got[k] - bsg[k]) <= 2e-2 * abs(bsg[k]), f"{route}: {k} rtol 2e-2")

    # fused-ad against fast_greeks of the same fused run (same paths, same
    # f32 r and dt tensors, so the same (cf, tau)): rtol 1e-4
    p_ad, g_ad = amcx_torch.price_and_greeks(SEED, market, product, spec, torch_sim,
                                             engine="fused-ad", device=dev)
    r_t, T_t = torch.tensor(R), torch.tensor(T)
    paths = amcx_torch.simulate_gbm(SEED, market, T_t, torch_sim, dev)
    am_spec = amcx_torch.resolve_regression_spec(spec, product, q=0.0)
    same_run = backward_induction_fused(paths, r_t, T_t / N_STEPS, STRIKE, -1.0, am_spec)
    g_fast = amcx_torch.fast_greeks(same_run, market, product, N_STEPS)
    del paths, same_run
    rel = {k: abs(float(g_ad[k]) - float(g_fast[k])) / abs(float(g_fast[k])) for k in g_fast}
    print(f"phase 7 American put fused-ad {float(p_ad):.5f} "
          f"{ {k: round(float(v), 5) for k, v in g_ad.items()} } vs fast_greeks of the same "
          f"run: max rel |d| {max(rel.values()):.3e}", flush=True)
    _require(max(rel.values()) <= 1e-4, f"fused-ad vs fast_greeks rel {rel}")

    fused_prices = []
    seeds = iter(range(SEED + 1, SEED + 1000))
    ms_fused = _time_ms(torch, lambda: fused_prices.append(fused_pricing(next(seeds)).price),
                        10, 2)
    mean10 = float(torch.stack(fused_prices[2:]).mean())
    print(f"phase 7 fused path: {ms_fused:.3f} ms/pricing (median of 10) = "
          f"{N_PATHS * N_STEPS / (ms_fused / 1e3):.4e} path-steps/s | mean of 10 timed "
          f"pricings {mean10:.5f} |err| {abs(mean10 - crr):.5f} | Greeks ms {greeks_ms}",
          flush=True)

    # ---- phase 8: kernels 8+9 (multi-asset step kernels) vs their plain ---
    # ---- versions, at the full-width 5-asset max-call ------------------------
    mc_spec = amcx_torch.RegressionSpec(basis="chebyshev", degree=2)
    mc_dt = MC_T / MC_DATES
    mc_sim = amcx_torch.SimConfig(n_paths=N_PATHS, n_steps=MC_DATES)

    def mc_paths(n_assets, seed):
        return amcx_torch.simulate_gbm_multi(seed, [S0] * n_assets, MC_R, MC_SIGMA, MC_T, mc_sim,
                                             q=MC_Q, device=dev)

    paths5 = mc_paths(5, SEED)
    torch.cuda.synchronize()
    _require(tuple(paths5.shape) == (MC_DATES + 1, N_PATHS, 5), "max-call paths shape")
    _require(bool(torch.isfinite(paths5).all()), "max-call paths finite")
    planes5, stats5 = maxcall_pallas.ma_inputs(paths5, MC_R, mc_dt, sorted_basis=True,
                                               exercise_from_step=1)
    t_ma, m5 = 5, 21
    mc_rdt = float(torch.tensor(MC_R) * torch.tensor(mc_dt))
    cf5 = maxcall_pallas._payoff_for(list(planes5[MC_DATES]), STRIKE, "maxcall")
    tau5 = torch.full((N_PATHS,), float(MC_DATES), device=dev)
    makw = dict(K=STRIKE, basis="chebyshev", degree=2, mode="total", sorted_basis=True)
    packed5 = ma_step_moments(stats5, t_ma, planes5[t_ma], cf5, tau5, rdt=mc_rdt, **makw)
    packed5_plain = ma_step_moments_reference(stats5, t_ma, planes5[t_ma], cf5, tau5, rdt=mc_rdt,
                                              **makw)
    coeffs5 = amcx_torch.pinv_solve(*unpack_moments(packed5_plain, m5))
    cf_k, tau_k, cf_p, tau_p = cf5.clone(), tau5.clone(), cf5.clone(), tau5.clone()
    ma_step_apply(stats5, t_ma, coeffs5, planes5[t_ma], cf_k, tau_k, **makw)
    ma_step_apply_reference(stats5, t_ma, coeffs5, planes5[t_ma], cf_p, tau_p, **makw)
    torch.cuda.synchronize()
    ma_moments_err = float(torch.max(torch.abs(packed5 - packed5_plain)))
    ma_apply_err = max(float(torch.max(torch.abs(cf_k - cf_p))),
                       float(torch.max(torch.abs(tau_k - tau_p))))
    n_ex5 = int((tau_k == t_ma).sum())
    # a step that is no exercise date: the kernel returns before reading a
    # path, cf and tau stay as they were
    stats5_off = stats5.clone()
    stats5_off[-1, t_ma] = 0.0
    cf_o, tau_o = cf5.clone(), tau5.clone()
    ma_step_apply(stats5_off, t_ma, coeffs5, planes5[t_ma], cf_o, tau_o, **makw)
    torch.cuda.synchronize()
    _require(torch.equal(cf_o, cf5) and torch.equal(tau_o, tau5),
             "ma apply on a non-exercise date leaves cf/tau untouched")
    del cf_o, tau_o, stats5_off
    _require(tuple(packed5.shape) == (252,), "packed moments P = 252")
    _require(ma_moments_err == 0.0, f"ma moments kernel vs plain max|d| {ma_moments_err:.3e} == 0")
    _require(ma_apply_err == 0.0 and n_ex5 > 0,
             f"ma apply kernel vs plain max|d| {ma_apply_err:.3e} == 0 ({n_ex5} exercised)")
    ms_ma_moments = _time_ms(torch, lambda: ma_step_moments(
        stats5, t_ma, planes5[t_ma], cf5, tau5, rdt=mc_rdt, **makw), 50, 5)
    ms_ma_moments_plain = _time_ms(torch, lambda: ma_step_moments_reference(
        stats5, t_ma, planes5[t_ma], cf5, tau5, rdt=mc_rdt, **makw), 5, 1)
    ms_ma_apply = _time_ms(torch, lambda: ma_step_apply(
        stats5, t_ma, coeffs5, planes5[t_ma], cf_k, tau_k, **makw), 50, 5)
    ms_ma_apply_plain = _time_ms(torch, lambda: ma_step_apply_reference(
        stats5, t_ma, coeffs5, planes5[t_ma], cf_p, tau_p, **makw), 10, 2)
    # one PyTorch call for the same Gram: A^T A of the materialized (n, 21)
    # design matrix (all-paths fit), in full f32, as amcx's XLA engine does
    cols5 = maxcall_pallas._columns(list(planes5[t_ma]), stats5, t_ma, "chebyshev", 2, "total",
                                    True)
    design5 = torch.stack(cols5, dim=1)
    del cols5
    ms_ma_moments_lib = _time_ms(torch, lambda: torch.mm(design5.T, design5), 50, 5)
    del design5, cf_k, tau_k, cf_p, tau_p
    prof8 = _profile(torch, lambda: ma_step_moments(stats5, t_ma, planes5[t_ma], cf5, tau5,
                                                    rdt=mc_rdt, **makw), 20)
    cf_k, tau_k = cf5.clone(), tau5.clone()
    prof9 = _profile(torch, lambda: ma_step_apply(stats5, t_ma, coeffs5, planes5[t_ma], cf_k,
                                                  tau_k, **makw), 50)
    host9_us = _host_us(torch, lambda: ma_step_apply(stats5, t_ma, coeffs5, planes5[t_ma], cf_k,
                                                     tau_k, **makw), 200)
    del cf_k, tau_k
    # kernel 9's bound: the step's 5 planes read once, cf/tau written where
    # a path exercises, the 2m-1 operations of the fit
    bound9 = _bound(5 * N_PATHS * 4 + 8 * n_ex5, f32_ops=N_PATHS * (2 * m5 - 1))
    # the design's floors: the 28 MB it reads, its f32 -> f64 widenings and
    # its DMMA a path (this run's SASS, else the design's 8 a column block
    # and a tile a column-block pair every 4 paths)
    mom = sass.get("ma_step", {})
    widen8 = mom.get("widenings_per_path_step", 8.0 * MA_COL_BLOCKS)
    dmma8 = mom.get("dmma_per_path_step", MA_TILES / 4)
    floor8 = {"bytes_us": bound_s({"bytes": 7 * N_PATHS * 4}) * 1e6,
              "conversions_us": N_PATHS * widen8 / F64_CONVERSIONS_PER_S * 1e6,
              "dmma_us": N_PATHS * dmma8 * DMMA_FLOPS / FP64_TENSOR_FLOPS * 1e6,
              "widenings_per_path": widen8, "dmma_per_path": dmma8,
              "counted_in_sass": bool(mom)}
    print(f"phase 8 one step t={t_ma} of the 5-asset max-call at {N_PATHS} paths (m = {m5}, "
          f"P = 252): moments kernel vs plain max|d| {ma_moments_err:.3e}, apply kernel vs plain "
          f"max|d| {ma_apply_err:.3e} ({n_ex5} paths exercised) | moments kernel "
          f"{ms_ma_moments:.4f} ms plain {ms_ma_moments_plain:.4f} ms library A^T A "
          f"{ms_ma_moments_lib:.4f} ms | apply kernel {ms_ma_apply:.4f} ms plain "
          f"{ms_ma_apply_plain:.4f} ms", flush=True)
    print(f"phase 8 kernel 8 device time per call: {prof8 or 'no device activity recorded'} | "
          f"design floors (us): {floor8}", flush=True)
    print(f"phase 8 kernel 9 device time per call: {prof9 or 'no device activity recorded'} | "
          f"host enqueue {host9_us:.2f} us a call | bound {bound9[0] * 1e3:.2f} us "
          f"({bound9[1]}) | non-exercise date: cf/tau untouched", flush=True)

    before = (ma_step_moments.launches, ma_step_apply.launches)
    ker = backward_induction_fused_maxcall(paths5, STRIKE, MC_R, mc_dt, mc_spec)
    again = backward_induction_fused_maxcall(paths5, STRIKE, MC_R, mc_dt, mc_spec)
    torch.cuda.synchronize()
    n_launch = (ma_step_moments.launches - before[0], ma_step_apply.launches - before[1])
    ref = backward_induction_fused_maxcall_reference(paths5, STRIKE, MC_R, mc_dt, mc_spec)
    torch.cuda.synchronize()
    ma_fused_diffs = {f: float(torch.max(torch.abs(getattr(ker, f) - getattr(ref, f))))
                      for f in ("price", "stderr", "cashflows", "exercise_times")}
    same_ref = all(torch.equal(a, b) for a, b in zip(ker[:4], ref[:4]))
    same_rerun = all(torch.equal(a, b) for a, b in zip(ker[:4], again[:4]))
    print(f"phase 8 fused induction, 5-asset max-call {N_PATHS}x{MC_DATES}: kernel "
          f"{float(ker.price):.6f} plain {float(ref.price):.6f} stderr {float(ker.stderr):.5f} | "
          f"max|d| {ma_fused_diffs} | launches (moments, apply) {n_launch} | equal to plain "
          f"{same_ref} | bit-identical rerun {same_rerun}", flush=True)
    _require(n_launch == (2 * MC_DATES, 2 * MC_DATES), f"fused max-call launches {n_launch}")
    _require(same_ref, f"fused max-call kernels equal to their plain versions {ma_fused_diffs}")
    _require(same_rerun, "fused max-call: two kernel runs bit-identical")
    ma_fused_err = max(ma_fused_diffs.values())
    del ker, again, ref

    # ---- phase 9: kernel 7 (multi-asset induction) vs its plain version ---
    ma_mega_err = 0.0
    for kind in ("maxcall", "basket"):
        kw = dict(payoff_kind=kind, degree=2, sorted_basis=kind == "maxcall",
                  exercise_from_step=1, return_cf_tau=True)
        before = lsmc_price_ma_mega.launches
        ker = lsmc_price_ma_mega(paths5, STRIKE, MC_R, mc_dt, **kw)
        again = lsmc_price_ma_mega(paths5, STRIKE, MC_R, mc_dt, **kw)
        torch.cuda.synchronize()
        n_launch = lsmc_price_ma_mega.launches - before
        ref = lsmc_price_ma_mega_reference(paths5, STRIKE, MC_R, mc_dt, **kw)
        torch.cuda.synchronize()
        diffs = [float(torch.max(torch.abs(a - b))) for a, b in zip(ker, ref)]
        same_ref = all(torch.equal(a, b) for a, b in zip(ker, ref))
        same_rerun = all(torch.equal(a, b) for a, b in zip(ker, again))
        n_ex = int((ker[3] < MC_DATES).sum())
        print(f"phase 9 ma-mega induction {kind} 5 assets {N_PATHS}x{MC_DATES}: kernel "
              f"{float(ker[0]):.6f} plain {float(ref[0]):.6f} stderr {float(ker[1]):.5f} | "
              f"max|d| price/stderr/cf/tau {diffs} | early-exercised paths {n_ex} | launches "
              f"{n_launch} | equal to plain {same_ref} | bit-identical rerun {same_rerun}",
              flush=True)
        _require(math.isfinite(float(ker[0])) and n_ex > 0, f"{kind}: finite price, exercise")
        _require(n_launch == 2, f"{kind}: ma-mega launches {n_launch}")
        _require(same_ref, f"{kind}: ma-mega kernel equal to its plain version {diffs}")
        _require(same_rerun, f"{kind}: two ma-mega runs bit-identical")
        ma_mega_err = max(ma_mega_err, *diffs)
        del ker, again, ref
    # the induction alone (asset-major planes, frame and stats built once)
    mega_in = lsmc_ma_mega.prepare(paths5, STRIKE, MC_R, mc_dt, payoff_kind="maxcall", degree=2,
                                   sorted_basis=True, exercise_from_step=1)
    ms_ma_mega = _time_ms(torch, lambda: lsmc_ma_mega._ma_mega_cuda(*mega_in, False, False), 20,
                          3)
    ms_ma_mega_plain = _time_ms(torch, lambda: lsmc_ma_mega._ma_mega_reference(
        *mega_in, False, False), 3, 1)
    prof7 = _profile(torch, lambda: lsmc_ma_mega._ma_mega_cuda(*mega_in, False, False), 5)
    # the design floor: the moments' DMMA and widenings a path on each of
    # the 9 dates (this run's SASS, as phase 8), whichever is larger
    mom7 = sass.get("ma_mega", {})
    widen7 = mom7.get("widenings_per_path_step", 8.0 * MA_COL_BLOCKS)
    dmma7 = mom7.get("dmma_per_path_step", MA_TILES / 4)
    floor7_ms = MC_DATES * N_PATHS * max(widen7 / F64_CONVERSIONS_PER_S,
                                         dmma7 * DMMA_FLOPS / FP64_TENSOR_FLOPS) * 1e3
    print(f"phase 9 ma-mega induction kernel {ms_ma_mega:.3f} ms plain {ms_ma_mega_plain:.3f} ms"
          f" | device time and launches per induction: {prof7 or 'no device activity recorded'}"
          f" | design floor (DMMA, widenings) {floor7_ms:.4f} ms | moments SASS a path-step "
          f"{mom7 or 'not counted'}", flush=True)
    del mega_in
    # the inductions' inputs: the asset-major planes and the frame in one
    # pass over the paths, against the transpose and the plain f64 frame
    mc_allow = (torch.arange(MC_DATES + 1, device=dev) >= 1).to(torch.float32)

    def prepare(plain=False):
        fn = maxcall_pallas.ma_prepare_reference if plain else maxcall_pallas.ma_prepare
        return fn(paths5, MC_R, mc_dt, mc_allow, sorted_basis=True)

    before = maxcall_pallas.ma_prepare.launches
    prep, prep_plain = prepare(), prepare(plain=True)
    torch.cuda.synchronize()
    prep_launches = maxcall_pallas.ma_prepare.launches - before
    prep_err = max(float(torch.max(torch.abs(a - b))) for a, b in zip(prep, prep_plain))
    _require(prep_launches == 1, f"ma_prepare launches {prep_launches}")
    _require(all(torch.equal(a, b) for a, b in zip(prep, prep_plain)),
             f"ma_prepare kernel equal to its plain version (max|d| {prep_err:.3e})")
    del prep, prep_plain
    ms_prep = _time_ms(torch, prepare, 20, 3)
    ms_prep_plain = _time_ms(torch, lambda: prepare(plain=True), 5, 1)
    ms_prep_copy = _time_ms(torch, lambda: paths5.permute(0, 2, 1).contiguous(), 20, 3)
    prof_prep = _profile(torch, prepare, 20)
    print(f"phase 9 ma_prepare kernel (planes and sorted frame, 5 assets {N_PATHS}x{MC_DATES}): "
          f"equal to plain, launches {prep_launches} | kernel {ms_prep:.4f} ms plain "
          f"{ms_prep_plain:.4f} ms, the transposing copy alone {ms_prep_copy:.4f} ms | device "
          f"{prof_prep or 'no device activity recorded'}", flush=True)

    # ---- phase 10: the basket pathgen kernel, then the slice at full width:
    # ---- price_max_call on the card ------------------------------------------
    # the kernel on the draw of phase 8's paths (their normals again), with
    # independent assets and with a correlation, against its plain chain
    mc_gen = torch.Generator(device=dev)
    mc_gen.manual_seed(SEED)
    mc_z = torch.randn((MC_DATES, N_PATHS, 5), generator=mc_gen, device=dev)
    mc_args = ([S0] * 5, MC_R, MC_SIGMA, MC_Q, MC_T)
    mc_corr = [[1.0 if a == b else 0.3 for b in range(5)] for a in range(5)]
    gm_equal = {}
    for case, corr in (("independent", None), ("corr 0.3", mc_corr)):
        ker = gbm_multi_paths(mc_z, *mc_args, corr)
        ref = gbm_multi_paths_reference(mc_z, *mc_args, corr)
        torch.cuda.synchronize()
        gm_equal[case] = (torch.equal(ker, ref), float(torch.max(torch.abs(ker - ref))))
        del ker, ref
    _require(torch.equal(paths5, gbm_multi_paths_reference(mc_z, *mc_args)),
             "phase 8's route paths are the plain chain's bits on the same draw")
    _require(all(eq for eq, _ in gm_equal.values()),
             f"gbm_multi kernel equal to its plain chain {gm_equal}")
    gm_err = max(err for _, err in gm_equal.values())
    ms_gm = _time_ms(torch, lambda: gbm_multi_paths(mc_z, *mc_args), 20, 3)
    ms_gm_plain = _time_ms(torch, lambda: gbm_multi_paths_reference(mc_z, *mc_args), 10, 2)
    # the route's pathgen before this kernel: the draw, then the chain
    ms_gm_chain = _time_ms(torch, lambda: gbm_multi_paths_reference(
        torch.randn((MC_DATES, N_PATHS, 5), generator=mc_gen, device=dev), *mc_args), 10, 2)
    prof_gm = _kernel_us(torch, lambda: gbm_multi_paths(mc_z, *mc_args), 20, "gbm_multi_kernel")
    # reads the normals once and writes the paths once
    bound_gm = _bound((2 * MC_DATES + 1) * 5 * N_PATHS * 4)
    print(f"phase 10 gbm_multi kernel (5 assets {N_PATHS}x{MC_DATES}): equal to plain "
          f"{gm_equal} | kernel {ms_gm:.4f} ms ({_launch_text(prof_gm)}) plain {ms_gm_plain:.4f} "
          f"ms, draw + chain {ms_gm_chain:.4f} ms | bound {bound_gm[0]:.4f} ms ({bound_gm[1]})",
          flush=True)
    del mc_z

    def max_call(engine, n_assets, seed=SEED):
        return amcx_torch.price_max_call(seed, [S0] * n_assets, STRIKE, MC_T, MC_R, MC_SIGMA,
                                         q=MC_Q, n_paths=N_PATHS, spec=mc_spec, engine=engine,
                                         return_paths=True, device=dev)

    def induction(engine, paths):
        if engine == "mega":
            return lsmc_price_ma_mega(paths, STRIKE, MC_R, mc_dt, degree=2, sorted_basis=True,
                                      exercise_from_step=1)[0]
        return backward_induction_fused_maxcall(paths, STRIKE, MC_R, mc_dt, mc_spec).price

    all_kernels = (gbm_paths, lsmc_price_megakernel, step_moments, step_apply, ma_step_moments,
                   ma_step_apply, lsmc_price_ma_mega, maxcall_pallas.ma_prepare, gbm_multi_paths)
    mc_launches, mc_ms = {}, {}
    for n_assets in (5, 2):
        res, mc_p = {}, {}
        for engine in ("mega", "fused"):
            torch.cuda.synchronize()
            for kernel in all_kernels:
                kernel.launches = 0
            res[engine], mc_p[engine] = max_call(engine, n_assets)
            torch.cuda.synchronize()
            mc_launches[(engine, n_assets)] = {
                "ma_step_moments": ma_step_moments.launches,
                "ma_step_apply": ma_step_apply.launches, "ma_mega": lsmc_price_ma_mega.launches,
                "ma_prepare": maxcall_pallas.ma_prepare.launches,
                "gbm_multi_paths": gbm_multi_paths.launches}
        # each route draws its paths with one gbm_multi launch and builds its
        # inputs with one ma_prepare launch
        want = (dict(ma_step_moments=0, ma_step_apply=0, ma_mega=1, ma_prepare=1,
                     gbm_multi_paths=1),
                dict(ma_step_moments=MC_DATES, ma_step_apply=MC_DATES, ma_mega=0, ma_prepare=1,
                     gbm_multi_paths=1))
        _require((mc_launches[("mega", n_assets)], mc_launches[("fused", n_assets)]) == want,
                 f"max-call routes launched their kernels {mc_launches}")
        _require(torch.equal(mc_p["mega"], mc_p["fused"]), "both routes priced the same paths")
        xla = amcx_torch.price_max_call(SEED, [S0] * n_assets, STRIKE, MC_T, MC_R, MC_SIGMA,
                                        q=MC_Q, n_paths=N_PATHS, spec=mc_spec, device=dev)
        p_m, p_f, p_x = (float(r.price) for r in (res["mega"], res["fused"], xla))
        se_f = float(res["fused"].stderr)
        lit = MC_VALUES[n_assets]
        for engine, p in (("mega", p_m), ("fused", p_f)):
            _require(math.isfinite(p) and abs(p - lit) <= MC_TOL,
                     f"{n_assets}-asset {engine} |{p:.5f} - {lit}| <= {MC_TOL}")
        _require(abs(p_f - p_m) <= 5e-3, f"|fused - mega| = {abs(p_f - p_m):.2e} <= 5e-3")
        _require(abs(p_x - p_f) <= se_f, f"|xla - fused| = {abs(p_x - p_f):.2e} <= {se_f:.5f}")
        del mc_p, xla
        for engine in ("mega", "fused"):
            seeds = iter(range(SEED + 1, SEED + 1000))
            ms_total = _time_ms(torch, lambda: max_call(engine, n_assets, next(seeds)), 10, 2)
            gen_ms, ind_ms = [], []
            for seed in range(SEED + 1000, SEED + 1010):
                e0, e1, e2 = (torch.cuda.Event(enable_timing=True) for _ in range(3))
                e0.record()
                paths = mc_paths(n_assets, seed)
                e1.record()
                induction(engine, paths)
                e2.record()
                e2.synchronize()
                gen_ms.append(e0.elapsed_time(e1))
                ind_ms.append(e1.elapsed_time(e2))
                del paths
            mc_ms[(engine, n_assets)] = (ms_total, statistics.median(gen_ms),
                                         statistics.median(ind_ms))
            if n_assets == 5:
                prof = _profile(torch, lambda: max_call(engine, 5), 3)
                print(f"phase 10 profile {engine} 5-asset pricing: "
                      f"{prof or 'no device activity recorded'}", flush=True)
        print(f"phase 10 max-call {n_assets} assets {N_PATHS}x{MC_DATES}: mega {p_m:.5f} stderr "
              f"{float(res['mega'].stderr):.5f} | fused {p_f:.5f} stderr {se_f:.5f} | xla {p_x:.5f}"
              f" | Andersen-Broadie {lit} |mega - lit| {abs(p_m - lit):.5f} |fused - mega| "
              f"{abs(p_f - p_m):.2e} |xla - fused| {abs(p_x - p_f):.2e} | launches per pricing "
              f"mega {mc_launches[('mega', n_assets)]} fused {mc_launches[('fused', n_assets)]} | "
              f"ms per pricing (median of 10; pathgen, induction): mega "
              f"{mc_ms[('mega', n_assets)]} fused {mc_ms[('fused', n_assets)]}", flush=True)
        del res
    del paths5, planes5, cf5, tau5

    # ---- phase 11: kernel 3 (the strike/maturity book) vs its plain ------
    # ---- version, at book-16-1M's shape ----------------------------------------
    book_market = amcx_torch.MarketParams(BOOK_S0, R, SIGMA)
    book_mean, book_inv_std = amcx_torch.gbm_standardization(book_market, T, N_STEPS, device=dev)
    frame = dict(mean_t=book_mean, inv_std_t=book_inv_std)
    ladder = torch.linspace(80.0, 120.0, BOOK_N)
    book_paths = gbm_paths(SEED + 11, BOOK_S0, R, SIGMA, 0.0, T, N_STEPS, N_PATHS, device=dev)
    anti_sim = amcx_torch.SimConfig(n_paths=N_PATHS, n_steps=N_STEPS, backend="torch",
                                    antithetic=True)
    anti_paths = amcx_torch.simulate_gbm(SEED + 12, book_market, T, anti_sim, device=dev)
    quarters = tuple(N_STEPS * q // 4 for q in (1, 2, 3, 4))  # maturity steps 25/50/75/100
    book_err = 0.0
    for case, bpaths, strikes, phi, kw in (
            ("16-put ladder, cf/tau", book_paths, ladder, -1.0, dict(return_cf_tau=True)),
            ("4 puts + 4 calls", book_paths, torch.linspace(85.0, 115.0, 8),
             torch.tensor([-1.0] * 4 + [1.0] * 4), {}),
            ("16 puts, shared down-in H=80", book_paths, ladder, -1.0, dict(barrier=80.0)),
            ("4 puts, maturities 25/50/75/100, antithetic", anti_paths,
             torch.linspace(85.0, 115.0, 4), -1.0,
             dict(maturity_steps=quarters, antithetic=True, return_cf_tau=True))):
        args, kw = (bpaths, strikes, R, dt, phi), dict(kw, **frame)
        before = lsmc_book_megakernel.launches
        ker = lsmc_book_megakernel(*args, **kw)
        again = lsmc_book_megakernel(*args, **kw)
        torch.cuda.synchronize()
        n_launch = lsmc_book_megakernel.launches - before
        ref = lsmc_book_mega_reference(*args, **kw)
        torch.cuda.synchronize()
        diffs = [float(torch.max(torch.abs(a - b))) for a, b in zip(ker, ref)]
        same_ref = all(torch.equal(a, b) for a, b in zip(ker, ref))
        same_rerun = all(torch.equal(a, b) for a, b in zip(ker, again))
        ex_note = ""
        if kw.get("return_cf_tau"):
            mats = torch.tensor(kw.get("maturity_steps", (N_STEPS,) * len(strikes)), device=dev)
            ex_note = f" | early-exercised paths {int((ker[3] < mats[:, None]).sum())}"
        print(f"phase 11 book kernel {case} {N_PATHS}x{N_STEPS}: prices "
              f"{[round(float(v), 5) for v in ker[0]]} stderrs max {float(ker[1].max()):.5f} | "
              f"max|d| price/stderr{'/cf/tau' if len(ker) == 4 else ''} {diffs}{ex_note} | "
              f"launches {n_launch} | equal to plain {same_ref} | bit-identical rerun "
              f"{same_rerun}", flush=True)
        _require(bool(torch.isfinite(ker[0]).all()) and bool((ker[1] > 0).all()),
                 f"book {case}: finite prices, positive stderrs")
        _require(n_launch == 2, f"book {case}: launches {n_launch}")
        _require(same_ref, f"book {case}: kernel equal to its plain version {diffs}")
        _require(same_rerun, f"book {case}: two kernel runs bit-identical")
        book_err = max(book_err, *diffs)
        prof11 = _profile(torch, lambda: lsmc_book_megakernel(*args, **kw), 1)
        print(f"phase 11 book kernel {case}: device us per step by kernel "
              f"{prof11 and {k: v / N_STEPS for k, v in prof11['top_us_per_call'].items()}}",
              flush=True)
        del ker, again, ref
    del anti_paths

    # ---- phase 12: the book through its entry points at full width -------
    def book_pricing(seed=SEED, **kw):
        bp = amcx_torch.simulate_gbm(seed, book_market, T, sim, device=dev)
        return bp, amcx_torch.price_strike_grid(bp, ladder, R, T, "put", True, spec_all,
                                                engine="mega", **frame, **kw)

    torch.cuda.synchronize()
    book_kernels = all_kernels + (lsmc_book_megakernel,)
    for kernel in book_kernels:
        kernel.launches = 0
    paths12, book = book_pricing()
    torch.cuda.synchronize()
    book_launches = {k.__name__: k.launches for k in book_kernels}
    _require(book_launches["gbm_paths"] == 1 and book_launches["lsmc_book_megakernel"] == 1
             and sum(book_launches.values()) == 2,
             f"the book path launched pathgen + kernel 3 once each {book_launches}")
    crr16 = torch.tensor([amcx_torch.crr_price(BOOK_S0, float(K), T, R, SIGMA, 2000,
                                               option_type="put", american=True)
                          for K in ladder], dtype=torch.float64)
    b_prices, b_se = book.prices.double().cpu(), book.stderrs.double().cpu()
    crr_err = torch.abs(b_prices - crr16)
    _require(bool(torch.isfinite(b_prices).all()) and bool((b_se > 0).all()),
             "book: finite prices, positive stderrs")
    _require(float(crr_err.max()) <= BOOK_CRR_TOL,
             f"book: max |price - CRR-2000| = {float(crr_err.max()):.5f} <= {BOOK_CRR_TOL}")
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    xla_book = amcx_torch.price_strike_grid(paths12, ladder, R, T, "put", True, spec_all)
    e1.record()
    e1.synchronize()
    ms_xla_book = e0.elapsed_time(e1)
    d_xla = float(torch.max(torch.abs(book.prices - xla_book.prices)))
    _require(d_xla <= 3e-3, f"book: max |mega - xla| = {d_xla:.2e} <= 3e-3")
    single = torch.stack([lsmc_price_megakernel(paths12, float(K), R, dt, -1.0, itm_weights=False,
                                                **frame) for K in ladder])
    n_bit = int((single == book.prices).sum())
    d_single = float(torch.max(torch.abs(single - book.prices)))
    _require(d_single <= 1e-4, f"book vs kernel 2 per strike: max |d| {d_single:.2e} <= 1e-4")
    mix_strikes, mix_mats = torch.linspace(85.0, 115.0, 8), quarters * 2
    mix_mega = amcx_torch.price_mixed_book(paths12, mix_strikes, mix_mats, R, T, "put", True,
                                           spec_all, engine="mega", **frame)
    mix_xla = amcx_torch.price_mixed_book(paths12, mix_strikes, mix_mats, R, T, "put", True,
                                          spec_all)
    d_mix = float(torch.max(torch.abs(mix_mega.prices - mix_xla.prices)))
    _require(d_mix <= 8e-3, f"mixed book: max |mega - xla| = {d_mix:.2e} <= 8e-3")
    _, cf_book = book_pricing(return_cf_tau=True)
    g_mega = amcx_torch.book_greeks(cf_book, book_market, ladder, T, N_STEPS)
    g_xla = amcx_torch.book_greeks(xla_book, book_market, ladder, T, N_STEPS)
    d_delta = float(torch.max(torch.abs(g_mega["delta"] - g_xla["delta"])))
    _require(d_delta <= 1e-2, f"book Greeks: max |delta mega - xla| = {d_delta:.2e} <= 1e-2")
    del cf_book, xla_book
    seeds = iter(range(SEED + 1, SEED + 1000))
    ms_book_pricing = _time_ms(torch, lambda: book_pricing(next(seeds)), 10, 2)
    ms_book = _time_ms(torch, lambda: lsmc_book_megakernel(paths12, ladder, R, dt, -1.0, **frame),
                       20, 3)
    ms_book_plain = _time_ms(torch, lambda: lsmc_book_mega_reference(paths12, ladder, R, dt, -1.0,
                                                                     **frame), 1, 0)
    ms_single = _time_ms(torch, lambda: lsmc_price_megakernel(paths12, 100.0, R, dt, -1.0,
                                                              itm_weights=False, **frame), 10, 2)
    book_rate = BOOK_N * N_PATHS * N_STEPS / (ms_book_pricing / 1e3)
    print(f"phase 12 book-16-1M (16 American puts K=80..120, S0={BOOK_S0}, {N_PATHS}x{N_STEPS}, "
          f"price_strike_grid mega): prices {[round(v, 5) for v in b_prices.tolist()]} | "
          f"CRR-2000 {[round(v, 5) for v in crr16.tolist()]} | max |err| "
          f"{float(crr_err.max()):.5f} (K={float(ladder[int(crr_err.argmax())]):.2f}) | stderr "
          f"max {float(b_se.max()):.5f} | launches {book_launches}", flush=True)
    print(f"phase 12 cross-checks: max |mega - xla book| {d_xla:.3e} | kernel 2 per strike: "
          f"{n_bit} of {BOOK_N} bit-equal, max |d| {d_single:.3e} | mixed maturities "
          f"{list(mix_mats)} max |mega - xla| {d_mix:.3e} | delta ladder max |mega - xla| "
          f"{d_delta:.3e}", flush=True)
    print(f"phase 12 book-16-1M: {ms_book_pricing:.3f} ms per book pricing (pathgen + kernel 3, "
          f"median of 10) = {book_rate:.4e} option-path-steps/s | kernel 3 alone {ms_book:.3f} "
          f"ms, plain {ms_book_plain:.3f} ms | xla book (16 strikes, one run) {ms_xla_book:.3f} "
          f"ms | kernel 2 for one strike {ms_single:.3f} ms", flush=True)
    prof = _profile(torch, lambda: book_pricing(), 3)
    print(f"phase 12 profile book pricing: {prof or 'no device activity recorded'}", flush=True)
    prof3 = _profile(torch, lambda: lsmc_book_megakernel(paths12, ladder, R, dt, -1.0, **frame),
                     3)
    per_step = prof3 and {name: us / N_STEPS for name, us in prof3["top_us_per_call"].items()}
    # the design's floors per step: the 16 V planes and S_t read once
    # (68 MB), and one f32 -> f64 conversion of each of the P_book products
    floor3 = {"v_bytes_us": bound_s({"bytes": (BOOK_N + 1) * N_PATHS * 4}) * 1e6,
              "conversions_us": N_PATHS * (15 + 5 * BOOK_N) / F64_CONVERSIONS_PER_S * 1e6}
    print(f"phase 12 kernel 3 device time per step by kernel (us): "
          f"{per_step or 'no device activity recorded'} | design floors per step (us): {floor3}",
          flush=True)
    del paths12, book_paths, book

    # ---- phase 13: kernel 6 (zero-path-memory induction) vs its plain ---
    # ---- version, and vs kernel 2 on the paths it regenerates -----------------
    fp_args = (S0, STRIKE, R, SIGMA, dt, N_STEPS, N_PATHS, -1.0)
    fit_a = dict(itm_weights=True, return_cf_tau=True, return_coeffs=True)
    fp_err, fp_coeffs_a = 0.0, None
    for case, seed, kw in (
            ("(a) ITM fit, cf/tau + coeffs", SEED + 21, fit_a),
            ("(b) all-paths fit", SEED + 22, dict(return_coeffs=True)),
            ("(c) down-in put H=90", SEED + 23, dict(fit_a, barrier=90.0)),
            ("(d) Bermudan every 10th step, antithetic", SEED + 24,
             dict(fit_a, exercise_steps=tuple(range(0, N_STEPS, 10)), antithetic=True)),
            ("(e) replay of (a)'s coeffs, new seed", SEED + 25, dict(return_cf_tau=True)),
            ("(f) degree 0", SEED + 26, dict(fit_a, degree=0)),
            ("(g) degree 10", SEED + 27, dict(fit_a, degree=10)),
            (f"(h) {FP_UNEVEN_PATHS} paths (an uneven grid)", SEED + 28,
             dict(fit_a, n_paths=FP_UNEVEN_PATHS))):
        if case.startswith("(e)"):
            kw = dict(kw, replay_coeffs=fp_coeffs_a)
        case_args = fp_args[:6] + (kw.pop("n_paths", N_PATHS), -1.0)
        before = lsmc_price_fusedpath.launches
        ker = lsmc_price_fusedpath(seed, *case_args, **kw, device=dev)
        again = lsmc_price_fusedpath(seed, *case_args, **kw, device=dev)
        torch.cuda.synchronize()
        n_launch = lsmc_price_fusedpath.launches - before
        ref = lsmc_price_fusedpath_reference(seed, *case_args, **kw, device=dev)
        torch.cuda.synchronize()
        fields = [f for f in ker._fields if getattr(ker, f) is not None]
        diffs = {f: float(torch.max(torch.abs(getattr(ker, f) - getattr(ref, f))))
                 for f in fields}
        same_ref = all(torch.equal(getattr(ker, f), getattr(ref, f)) for f in fields)
        same_rerun = all(torch.equal(getattr(ker, f), getattr(again, f)) for f in fields)
        n_ex = "" if ker.exercise_times is None else (
            f" | early-exercised paths {int((ker.exercise_times < N_STEPS).sum())}")
        print(f"phase 13 fusedpath kernel {case_args[6]}x{N_STEPS} {case}: kernel "
              f"{float(ker.price):.6f} plain {float(ref.price):.6f} stderr "
              f"{float(ker.stderr):.5f} | max|d| {diffs}{n_ex} | launches {n_launch} | equal to "
              f"plain {same_ref} | bit-identical rerun {same_rerun}", flush=True)
        _require(math.isfinite(float(ker.price)) and float(ker.stderr) > 0,
                 f"fusedpath {case}: finite price, positive stderr")
        _require(n_launch == 2, f"fusedpath {case}: launches {n_launch}")
        _require(same_ref, f"fusedpath {case}: kernel equal to its plain version {diffs}")
        _require(same_rerun, f"fusedpath {case}: two kernel runs bit-identical")
        fp_err = max(fp_err, *diffs.values())
        if case.startswith("(a)"):
            fp_coeffs_a = ker.coeffs
            fp_a = ker
        del ker, again, ref
    # kernel 2 on the (T+1, n) spots kernel 6 regenerates for case (a): the
    # one place this route's 424 MB path array exists
    fp_paths = fusedpath_paths_reference(SEED + 21, S0, R, SIGMA, dt, N_STEPS, N_PATHS,
                                         device=dev)
    fp_mean, fp_inv_std = amcx_torch.gbm_standardization(market, dt * N_STEPS, N_STEPS,
                                                         device=dev)
    mega_a = lsmc_price_megakernel(fp_paths, STRIKE, R, dt, -1.0, itm_weights=True,
                                   mean_t=fp_mean, inv_std_t=fp_inv_std, return_cf_tau=True,
                                   return_coeffs=True)
    torch.cuda.synchronize()
    k2_diffs = {f: float(torch.max(torch.abs(getattr(mega_a, f) - getattr(fp_a, f))))
                for f in mega_a._fields}
    k2_same = all(torch.equal(a, b) for a, b in zip(mega_a, fp_a))
    print(f"phase 13 kernel 6 vs kernel 2 on the regenerated paths (case (a)): fusedpath "
          f"{float(fp_a.price):.6f} mega {float(mega_a.price):.6f} | max|d| {k2_diffs} | "
          f"equal {k2_same}", flush=True)
    _require(k2_same, f"kernel 6 equal to kernel 2 on its own paths {k2_diffs}")
    fp_err = max(fp_err, *k2_diffs.values())
    del fp_paths, mega_a, fp_a

    # ---- phase 14: the route at full width: price_option(engine= ---------
    # ---- "fusedpath"), price_out_of_sample, 1M x 1000 ---------------------------
    def fp_pricing(seed=SEED, prod=product, psim=sim):
        return amcx_torch.price_option(seed, market, prod, spec, psim, engine="fusedpath",
                                       device=dev)

    fp_kernels = book_kernels + (lsmc_price_fusedpath,)
    torch.cuda.synchronize()
    for kernel in fp_kernels:
        kernel.launches = 0
    res = fp_pricing()
    torch.cuda.synchronize()
    fp_launches = {k.__name__: k.launches for k in fp_kernels}
    fp_price, fp_se = float(res.price), float(res.stderr)
    _require(fp_launches["lsmc_price_fusedpath"] == 1 and sum(fp_launches.values()) == 1,
             f"the fusedpath route launched kernel 6 alone {fp_launches}")
    _require(math.isfinite(fp_price) and math.isfinite(fp_se) and fp_se > 0,
             "fusedpath finite price/stderr")
    _require(abs(fp_price - crr) <= 4 * fp_se + 0.005,
             f"fusedpath |price - CRR-2000| = {abs(fp_price - crr):.5f} <= 4*{fp_se:.5f} + 0.005")
    fp_di = fp_pricing(prod=di_prod)
    fp_di_err = abs(float(fp_di.price) - crr_di)
    _require(fp_di_err <= 0.2, f"fusedpath down-in |price - CRR barrier tree| = "
                               f"{fp_di_err:.5f} <= 0.2")
    print(f"phase 14 fusedpath route {N_PATHS}x{N_STEPS} American put: price {fp_price:.5f} "
          f"stderr {fp_se:.5f} CRR-2000 {crr:.5f} |err| {abs(fp_price - crr):.5f} | launches "
          f"{fp_launches} | down-in H=90 {float(fp_di.price):.5f} stderr "
          f"{float(fp_di.stderr):.5f} CRR-100 barrier tree {crr_di:.5f} |err| {fp_di_err:.5f}",
          flush=True)

    for kernel in fp_kernels:
        kernel.launches = 0
    t_oos = time.perf_counter()
    oos = amcx_torch.price_out_of_sample(SEED + 77, market, product, spec, sim,
                                         engine="fusedpath", replay_engine="fusedpath",
                                         replay_blocks=OOS_BLOCKS, device=dev)
    oos_price, oos_se = float(oos.oos.price), float(oos.oos.stderr)
    oos_s = time.perf_counter() - t_oos
    oos_launches = lsmc_price_fusedpath.launches
    _require(oos_launches == 1 + OOS_BLOCKS, f"OOS fit + {OOS_BLOCKS} replays: {oos_launches}")
    _require(crr - 0.03 <= oos_price <= crr + 4 * oos_se,
             f"OOS {oos_price:.5f} in [CRR - 0.03, CRR + 4*{oos_se:.5f}] around {crr:.5f}")
    deep_sim = amcx_torch.SimConfig(n_paths=N_PATHS, n_steps=DEEP_STEPS)
    deep = fp_pricing(psim=deep_sim)
    deep_err = abs(float(deep.price) - crr)
    _require(math.isfinite(float(deep.price)) and deep_err <= 0.05,
             f"1M x {DEEP_STEPS} |price - CRR-2000| = {deep_err:.5f} <= 0.05")
    seeds = iter(range(SEED + 2000, SEED + 3000))
    ms_oos = _time_ms(torch, lambda: amcx_torch.price_out_of_sample(
        next(seeds), market, product, spec, sim, engine="fusedpath", replay_engine="fusedpath",
        replay_blocks=OOS_BLOCKS, device=dev).oos.price, 3, 1)
    ms_deep = _time_ms(torch, lambda: fp_pricing(next(seeds), psim=deep_sim).price, 3, 1)
    print(f"phase 14 out of sample {1 + OOS_BLOCKS}M x {N_STEPS} (fit 1M, {OOS_BLOCKS} replay "
          f"blocks of 1M): fit {float(oos.fit.price):.5f} OOS {oos_price:.5f} stderr "
          f"{oos_se:.5f} CRR-2000 {crr:.5f} err {oos_price - crr:+.5f} | launches "
          f"{oos_launches} | first call {oos_s * 1e3:.1f} ms, {ms_oos:.3f} ms per OOS pricing "
          f"(median of 3) | 1M x {DEEP_STEPS} ITM put {float(deep.price):.5f} stderr "
          f"{float(deep.stderr):.5f} |err| {deep_err:.5f}, {ms_deep:.3f} ms (median of 3)",
          flush=True)
    del oos, deep

    def added_memory(fn):
        """Device bytes one call adds at its peak over what was allocated
        before it."""
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out = fn()
        torch.cuda.synchronize()
        added = torch.cuda.max_memory_allocated() - before
        del out
        return added

    mem_fp = added_memory(lambda: fp_pricing().price)
    mem_mega = added_memory(lambda: pricing().price)
    _require(mem_fp < FP_MEMORY_CAP, f"fusedpath adds {mem_fp} B < {FP_MEMORY_CAP} B")
    _require(mem_mega >= (N_STEPS + 1) * N_PATHS * 4,
             f"the mega pipeline adds {mem_mega} B >= the (T+1, n) paths")
    route_ms = {}
    for name, fn in (("fusedpath", fp_pricing), ("mega", pricing), ("mega 2", pricing),
                     ("fusedpath 2", fp_pricing)):
        seeds = iter(range(SEED + 4000, SEED + 5000))
        route_ms[name] = _time_ms(torch, lambda fn=fn: fn(next(seeds)).price, 20, 3)
    print(f"phase 14 ms per 1M x {N_STEPS} pricing (median of 20, in this order): {route_ms} | "
          f"device memory added during one pricing: fusedpath {mem_fp / 2 ** 20:.2f} MiB, mega "
          f"pipeline {mem_mega / 2 ** 20:.2f} MiB", flush=True)
    prof = _profile(torch, lambda: fp_pricing(), 3)
    print(f"phase 14 profile fusedpath pricing: {prof or 'no device activity recorded'}",
          flush=True)
    fkw = dict(itm_weights=True, return_stats=True)
    ms_fp = _time_ms(torch, lambda: lsmc_price_fusedpath(SEED, *fp_args, **fkw, device=dev), 20,
                     3)
    ms_fp_plain = _time_ms(torch, lambda: lsmc_price_fusedpath_reference(
        SEED, *fp_args, **fkw, device=dev), 2, 1)
    prof6 = _profile(torch, lambda: lsmc_price_fusedpath(SEED, *fp_args, **fkw, device=dev), 3)
    # the design floor: one f32 -> f64 conversion of each of the 20 moment
    # products a path-step (the cooperative kernel moves no path bytes)
    floor6_ms = N_STEPS * N_PATHS * 20 / F64_CONVERSIONS_PER_S * 1e3
    print(f"phase 14 kernel 6 alone {ms_fp:.3f} ms, plain {ms_fp_plain:.3f} ms | device "
          f"{prof6 or 'no device activity recorded'} | design floor (conversions) "
          f"{floor6_ms:.4f} ms", flush=True)

    sw = _swing_phases(torch, dev, amcx_torch)
    qmc = _qmc_phases(torch, dev, amcx_torch, sass)
    ccr = _ccr_phase(torch, dev, amcx_torch)
    _rqmc_phase(torch, dev, amcx_torch)

    # ---- bounds: bytes each kernel must move and its arithmetic ----------
    P4, k4 = 20, 5  # step kernels and mega induction: Chebyshev degree 4
    P_book = 15 + k4 * BOOK_N  # the book's shared Gram head + 16 rhs rows
    P21 = 252
    row = N_PATHS * 4
    # kernel 6, per path-step: a quarter of a Philox4x32-10 call (10 rounds
    # of 2 mul.hi, 2 mul.lo, 4 xor, 2 key adds: 25 integer operations, at
    # half the f32 rate since an SM has 64 INT32 lanes against 128 FP32, so
    # 50 f32 slots), half a Box-Muller pair (two uniforms of 4 operations,
    # log, scale, sqrt, angle, cos, sin, two products: 8), the bridge
    # multiply-add (3), the spot (sigma W, + drift, exp, S0 *: 4), the P f32
    # products (and their P f64 sums) and the 2k-1 operations of the fit;
    # its bytes are only the stats rows in and the two sums out
    fp_f32 = 2 * 25 + 8 + 3 + 4 + P4 + 2 * k4 - 1
    bounds = {
        "lsmc_fusedpath": _bound(4 * (N_STEPS + 1) * 4 + 2 * 4,
                                 f32_ops=N_STEPS * N_PATHS * fp_f32,
                                 f64_ops=N_STEPS * N_PATHS * P4),
        "gbm_paths": bound1,
        # reads the paths once; per path-step the P pair products (f32) and
        # their f64 sums, and the 2k-1 operations of the fitted continuation
        "lsmc_mega": _bound((N_STEPS + 1) * row + 4 * (N_STEPS + 1) * 4,
                            f32_ops=N_STEPS * N_PATHS * (P4 + 2 * k4 - 1),
                            f64_ops=N_STEPS * N_PATHS * P4),
        # reads S_t, cf, tau; P products and f64 sums per path
        "lsmc_step_moments": _bound(3 * row, f32_ops=N_PATHS * P4, f64_ops=N_PATHS * P4),
        # reads S_t (never cf or tau), writes the surface row and cf/tau of
        # the exercised paths
        "lsmc_step_apply": _bound(2 * row + 8 * n_ex_step, f32_ops=N_PATHS * (2 * k4 - 1)),
        # reads the 5 asset planes of every date once; per path and step the
        # 252 exact f64 products and their f64 sums (the FP64 tensor cores'
        # work), and the 2m-1 operations of the fitted continuation on the 8
        # exercise dates
        "ma_mega": _bound((MC_DATES + 1) * 5 * row, f32_ops=8 * N_PATHS * (2 * m5 - 1),
                          tensor_f64_ops=2 * MC_DATES * N_PATHS * P21),
        # reads the 5-asset paths once and writes their planes once
        "ma_prepare": _bound(2 * (MC_DATES + 1) * 5 * row),
        "gbm_multi": bound_gm,
        # reads the step's 5 planes, cf and tau; 252 exact f64 products and
        # their f64 sums (the FP64 tensor cores' work)
        "ma_step_moments": _bound(7 * row, tensor_f64_ops=2 * N_PATHS * P21),
        # reads the step's 5 planes (never cf or tau), writes cf/tau of the
        # exercised paths (phase 8)
        "ma_step_apply": bound9,
        # reads the paths once; per path-step the P_book products (f32) and
        # their f64 sums, and 16 fitted continuations of 2k-1 operations
        "lsmc_book": _bound((N_STEPS + 1) * row + 4 * (N_STEPS + 1) * 4,
                            f32_ops=N_STEPS * N_PATHS * (P_book + BOOK_N * (2 * k4 - 1)),
                            f64_ops=N_STEPS * N_PATHS * P_book),
        "lsmc_swing": sw["bound"],
        "sobol_gbm": qmc["increment"]["bound"],
        "sobol_gbm_bridge": qmc["bridge"]["bound"],
        "ccr_exposures": ccr["bound"],
    }

    print(smi)
    print(json.dumps({"kernels": [dict(k, bound_ms=bounds[k["name"]][0],
                                       bound_by=bounds[k["name"]][1]) for k in [
        {"name": "gbm_paths", "route": "cuda", "source": "amcx_torch/csrc/gbm.cu",
         "replaces": "amcx/ops/gbm_pallas.py:115", "launches": launches["gbm_paths"],
         "max_abs_err": gbm_err, "ms": ms_gbm, "plain_ms": ms_gbm_plain, "library_ms": None,
         "device_us": device1_us, "design_floor_ms": floor1_ms},
        {"name": "lsmc_mega", "route": "cuda", "source": "amcx_torch/csrc/lsmc_mega.cu",
         "replaces": "amcx/ops/lsmc_megakernel.py:282", "launches": launches["lsmc_mega"],
         "max_abs_err": mega_err, "ms": ms_mega, "plain_ms": ms_mega_plain, "library_ms": None},
        {"name": "lsmc_step_moments", "route": "cuda", "source": "amcx_torch/csrc/lsmc_step.cu",
         "replaces": "amcx/ops/lsmc_pallas.py:117",
         "launches": fused_launches["lsmc_step_moments"],
         "max_abs_err": max(moments_err, fused_err), "ms": ms_moments,
         "plain_ms": ms_moments_plain, "library_ms": ms_moments_lib},
        {"name": "lsmc_step_apply", "route": "cuda", "source": "amcx_torch/csrc/lsmc_step.cu",
         "replaces": "amcx/ops/lsmc_pallas.py:249", "launches": fused_launches["lsmc_step_apply"],
         "max_abs_err": max(apply_err, fused_err), "ms": ms_apply, "plain_ms": ms_apply_plain,
         "library_ms": None, "device_us": prof5 and prof5["device_us_per_call"],
         "host_us": host5_us},
        {"name": "ma_mega", "route": "cuda", "source": "amcx_torch/csrc/lsmc_ma_mega.cu",
         "replaces": "amcx/ops/lsmc_ma_mega.py:94",
         "launches": mc_launches[("mega", 5)]["ma_mega"], "max_abs_err": ma_mega_err,
         "ms": ms_ma_mega, "plain_ms": ms_ma_mega_plain, "library_ms": None},
        {"name": "ma_prepare", "route": "cuda", "source": "amcx_torch/csrc/ma_prepare.cu",
         "replaces": "amcx/models/maxcall.py:85 (XLA ops, no Pallas kernel)",
         "launches": mc_launches[("mega", 5)]["ma_prepare"], "max_abs_err": prep_err,
         "ms": ms_prep,
         "plain_ms": ms_prep_plain, "library_ms": None,
         "device_us": prof_prep and prof_prep["device_us_per_call"]},
        {"name": "gbm_multi", "route": "cuda", "source": "amcx_torch/csrc/gbm_multi.cu",
         "replaces": "amcx/paths.py:137 (XLA ops, no Pallas kernel)",
         "launches": mc_launches[("mega", 5)]["gbm_multi_paths"], "max_abs_err": gm_err,
         "ms": ms_gm, "plain_ms": ms_gm_plain, "library_ms": None,
         "device_us": prof_gm and prof_gm[0]},
        {"name": "ma_step_moments", "route": "cuda", "source": "amcx_torch/csrc/ma_step.cu",
         "replaces": "amcx/ops/maxcall_pallas.py:137",
         "launches": mc_launches[("fused", 5)]["ma_step_moments"],
         "max_abs_err": max(ma_moments_err, ma_fused_err), "ms": ms_ma_moments,
         "plain_ms": ms_ma_moments_plain, "library_ms": ms_ma_moments_lib},
        {"name": "ma_step_apply", "route": "cuda", "source": "amcx_torch/csrc/ma_step.cu",
         "replaces": "amcx/ops/maxcall_pallas.py:239",
         "launches": mc_launches[("fused", 5)]["ma_step_apply"],
         "max_abs_err": max(ma_apply_err, ma_fused_err), "ms": ms_ma_apply,
         "plain_ms": ms_ma_apply_plain, "library_ms": None,
         "device_us": prof9 and prof9["device_us_per_call"], "host_us": host9_us},
        {"name": "lsmc_book", "route": "cuda", "source": "amcx_torch/csrc/lsmc_book.cu",
         "replaces": "amcx/ops/lsmc_megakernel.py:485",
         "launches": book_launches["lsmc_book_megakernel"], "max_abs_err": book_err,
         "ms": ms_book, "plain_ms": ms_book_plain, "library_ms": None},
        {"name": "lsmc_fusedpath", "route": "cuda", "source": "amcx_torch/csrc/lsmc_fusedpath.cu",
         "replaces": "amcx/ops/lsmc_fusedpath.py:79",
         "launches": fp_launches["lsmc_price_fusedpath"], "max_abs_err": fp_err, "ms": ms_fp,
         "plain_ms": ms_fp_plain, "library_ms": None},
        {"name": "lsmc_swing", "route": "cuda", "source": "amcx_torch/csrc/lsmc_swing.cu",
         "replaces": "amcx/ops/lsmc_swing.py:49", "launches": sw["launches"],
         "max_abs_err": sw["max_abs_err"], "ms": sw["ms"], "plain_ms": sw["plain_ms"],
         "library_ms": None},
        *({"name": name, "route": "cuda", "source": "amcx_torch/csrc/sobol_gbm.cu",
           "replaces": "amcx/ops/sobol_pallas.py:92", "launches": row["launches"],
           "max_abs_err": row["max_abs_err"], "ms": row["ms"], "plain_ms": row["plain_ms"],
           "library_ms": None, "device_us": row["device_us"],
           "design_floor_ms": row["design_floor_ms"]}
          for name, row in (("sobol_gbm", qmc["increment"]),
                            ("sobol_gbm_bridge", qmc["bridge"]))),
        {"name": "ccr_exposures", "route": "cuda", "source": "amcx_torch/csrc/ccr_exposures.cu",
         "replaces": "amcx/exposures.py:113 (XLA ops, no Pallas kernel)",
         "launches": ccr["launches"], "max_abs_err": ccr["max_abs_err"], "ms": ccr["ms"],
         "plain_ms": ccr["plain_ms"], "library_ms": None, "device_us": ccr["device_us"],
         "design_floor_ms": ccr["design_floor_ms"]},
    ]]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
