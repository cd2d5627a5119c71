"""Static resource model for the port's CUDA kernels on the H100.

The JAX package prices each Pallas kernel's VMEM working set
(`src/repro/kernels/resource_model.py`); that model does not carry over,
since a CUDA kernel commits other resources.  This one states, before a
kernel runs, what each kernel body of `csrc/` commits per launch:

  * threads per CTA and CTAs in the grid, as the C entry launches them;
  * static shared bytes (the body's `__shared__` arrays) and the dynamic
    shared bytes its launch requests;
  * the register ceiling its `__launch_bounds__` implies (the most a thread
    may use, not what the compiler gave it);
  * the thread block cluster's size, where there is one;
  * CTAs an SM holds at once, from threads, that register ceiling and
    shared memory (so a lower bound on the real occupancy).

Each estimator follows the wrapper's body choice (`plan` / `tiles`) and the
`.cu` source: `*_call` functions give the bodies one call launches, with the
card's SM count as a parameter (132 on the H100 SXM), so the model runs
without a card.  `validate()` holds an estimate inside the H100's limits;
`chip_smoke.py`'s `[resources]` phase holds the static and dynamic bytes
against `cudaFuncGetAttributes` (`csrc/attributes.cu`) and the register
ceiling against the registers the compiler gave.  `MODELED_KERNELS` maps
every `__global__` in `csrc/` to its estimator, and a test fails on a body
without an entry or an entry without a body.

The sparse bodies of B1 and B3 are templated over tile shapes
(`TILE_ROWS` x `TILE_P`); `effective_tiles` clamps an `Execution`'s
`tmm_block_m` / `tmm_block_p` to the template that runs, which is what
the serving engine's tile race (`kernels/autotune.py`) dedupes by.  B2's
two bodies are templated over the columns of B a CTA updates
(`EASI_SMALL_COLS`, `EASI_SPLIT_COLS`); `effective_easi_tile` maps an
`Execution`'s `easi_block_m` onto them as the C entry does.

Importing this module needs torch for nothing: no card, no build.
`python -m repro_torch.kernels.resource_model --json FILE` writes the
report rows.

H100 SXM limits, each from NVIDIA's CUDA C++ Programming Guide (table
"Technical Specifications per Compute Capability", compute capability 9.0)
unless said otherwise.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from typing import Callable, Dict, List, Optional, Tuple

SMEM_PER_CTA = 232_448        # 227 KB of shared memory a CTA may opt in to
SMEM_PER_SM = 233_472         # 228 KB of shared memory an SM holds
SMEM_RESERVED_PER_CTA = 1024  # 1 KB an SM reserves for each resident CTA (the guide's
                              # compute capability 9.0 shared memory section)
SMEM_STATIC_MAX = 49_152      # 48 KB of static shared memory a kernel may declare
THREADS_PER_CTA = 1024
THREADS_PER_SM = 2048
REGS_PER_SM = 65_536
REGS_PER_THREAD = 255
REG_ALLOC_WARP = 256          # registers are given to a warp in units of 256
CTAS_PER_SM = 32
CLUSTER_PORTABLE = 8          # CTAs in a portable thread block cluster (the guide's
                              # thread block clusters section)
GRID_Y_Z_MAX = 65_535
GRID_X_MAX = 2 ** 31 - 1
H100_SMS = 132                # SMs of an H100 SXM (NVIDIA's data sheet)

# csrc/ternary_encode.cuh and common.cuh
DENSE_MAX_R = 65_536          # FT_DENSE_MAX_R: a smaller R (p * m entries) takes the dense body
FT_ROWS = 32
FT_WARPS = 8
FT_THREADS = 32 * FT_WARPS
FT_PMIN = 8
FT_CTAS_PER_SM = 2
FT_QUEUE = 64
TILE = 32                     # the dense bodies' output tile and contraction chunk
NTHREADS = 256                # 16 x 16 threads
TILE_ROWS = (32, 64)          # sparse bodies: rows of x a CTA (template RL = 1, 2)
TILE_P = (16, 32, 64)         # sparse bodies: rows of R a CTA at most (template PT)
DEFAULT_TILE = (32, 64)       # the sparse bodies' tiling before they were templated
WORD = 32                     # the sparse bodies walk the contraction a 32-column word at a time
DENSE_TILES = (TILE, TILE)
F32 = 4


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def effective_tiles(rows: int, p: int, m: int, block_m: int = 128,
                    block_p: int = 128) -> Tuple[int, int]:
    """The (rows of x, rows of R) a CTA of B1 or B3 runs for an
    `Execution`'s (tmm_block_m, tmm_block_p) on a (rows, p, m) problem.  The
    dense body (R under DENSE_MAX_R entries) has one tiling.  The sparse
    body runs the template the two fields name; a field that names none
    (the reference's Pallas sizes, `Execution`'s defaults of 128 among
    them) runs DEFAULT_TILE's.  Then no larger than the padded problem
    needs: 32 rows where rows <= 32, the smallest PT that holds p.  Both
    bodies walk the contraction a fixed step (TILE or WORD columns), so
    `tmm_block_k` names nothing here."""
    if p * m < DENSE_MAX_R:
        return DENSE_TILES
    bm = block_m if block_m in TILE_ROWS else DEFAULT_TILE[0]
    if rows <= TILE_ROWS[0]:
        bm = TILE_ROWS[0]
    bp = block_p if block_p in TILE_P else DEFAULT_TILE[1]
    bp = min(bp, min(t for t in TILE_P if t >= min(p, TILE_P[-1])))
    return bm, bp


def ft_p_tiles(rows: int, p: int, sms: int, pmax: int, cta_rows: int) -> int:
    """`ternary_encode.cuh`'s ft_p_tiles: the sparse bodies' p tiles."""
    row_tiles, target = _cdiv(rows, cta_rows), FT_CTAS_PER_SM * sms
    splits = _cdiv(p, pmax)
    if row_tiles < target:
        splits = max(splits, min(_cdiv(p, FT_PMIN), _cdiv(target, row_tiles)))
    return _cdiv(p, _cdiv(p, splits))


@dataclasses.dataclass(frozen=True)
class KernelEstimate:
    """What one launch of one kernel body commits."""

    kernel: str                  # the __global__ function
    source: str                  # its file under csrc/
    variant: str                 # the template instance, e.g. "RL=1,PT=64"
    threads: int                 # per CTA
    grid: Tuple[int, ...]
    static_smem: int             # bytes of __shared__ arrays
    dynamic_smem: int            # bytes the launch requests
    min_ctas: int = 1            # __launch_bounds__' second argument
    cluster: int = 1             # CTAs in a thread block cluster
    lookup: Tuple[int, ...] = ()  # (source, body, a, b, c, d) for csrc/attributes.cu

    @property
    def smem(self) -> int:
        return self.static_smem + self.dynamic_smem

    @property
    def reg_ceiling(self) -> int:
        """The most registers a thread may use under __launch_bounds__(threads,
        min_ctas): the register file split over min_ctas CTAs, in the
        allocation granularity, at most 255."""
        per_warp = REGS_PER_SM // (self.min_ctas * _cdiv(self.threads, 32))
        return min(REGS_PER_THREAD, (per_warp // REG_ALLOC_WARP) * REG_ALLOC_WARP // 32)

    @property
    def ctas_per_sm(self) -> int:
        """CTAs an SM holds at once, with every thread at the register ceiling."""
        warps = _cdiv(self.threads, 32)
        regs_warp = _cdiv(self.reg_ceiling * 32, REG_ALLOC_WARP) * REG_ALLOC_WARP
        by_smem = SMEM_PER_SM // (self.smem + SMEM_RESERVED_PER_CTA)
        return min(CTAS_PER_SM, THREADS_PER_SM // self.threads,
                   REGS_PER_SM // (regs_warp * warps), by_smem)

    def validate(self) -> List[str]:
        """The H100 limits this launch breaks (empty: none)."""
        name = f"{self.kernel}<{self.variant}>"
        out = []
        if self.threads > THREADS_PER_CTA:
            out.append(f"{name}: {self.threads} threads a CTA > {THREADS_PER_CTA}")
        if self.static_smem > SMEM_STATIC_MAX:
            out.append(f"{name}: static shared {self.static_smem} B > {SMEM_STATIC_MAX}")
        if self.smem > SMEM_PER_CTA:
            out.append(f"{name}: shared {self.smem} B a CTA > {SMEM_PER_CTA}")
        if self.min_ctas * (self.smem + SMEM_RESERVED_PER_CTA) > SMEM_PER_SM:
            out.append(f"{name}: __launch_bounds__ asks {self.min_ctas} CTAs an SM, whose "
                       f"shared memory ({self.smem} B each) does not fit {SMEM_PER_SM}")
        if self.cluster > CLUSTER_PORTABLE:
            out.append(f"{name}: cluster of {self.cluster} > {CLUSTER_PORTABLE}")
        if self.ctas_per_sm < 1:
            out.append(f"{name}: no CTA fits an SM")
        if self.grid[0] > GRID_X_MAX or any(g > GRID_Y_Z_MAX for g in self.grid[1:]):
            out.append(f"{name}: grid {self.grid} beyond the launch limits")
        if self.cluster > 1 and self.grid[-1] % self.cluster:
            out.append(f"{name}: grid {self.grid} not a whole number of clusters")
        return out

    def to_row(self) -> dict:
        return {"name": f"kernel_resources/{self.kernel}<{self.variant}>",
                "source": self.source, "threads": self.threads, "grid": list(self.grid),
                "static_smem": self.static_smem, "dynamic_smem": self.dynamic_smem,
                "reg_ceiling": self.reg_ceiling, "cluster": self.cluster,
                "ctas_per_sm": self.ctas_per_sm}


def _dtype_code(bf16: bool) -> int:
    return 1 if bf16 else 0   # _build.DTYPE_CODES


def _or(v: Optional[bool], default: bool) -> bool:
    return default if v is None else v


def _dtypes(bf16: bool, b_bf16: Optional[bool] = None) -> str:
    """A variant's dtypes: x's (or y's), then B's where it has its own."""
    name = "bf16" if bf16 else "f32"
    return name if b_bf16 is None else f"{name}/{'bf16' if b_bf16 else 'f32'}"


# ---- the twelve bodies -----------------------------------------------------------

def ternary_matmul_dense_estimate(b: int, m: int, p: int, *, bf16: bool = False
                                  ) -> KernelEstimate:
    """ternary_matmul.cu `ternary_matmul_dense_kernel`: 16 x 16 threads a 32 x
    32 tile of y; xs, rs [32][33] f32."""
    return KernelEstimate(
        "ternary_matmul_dense_kernel", "ternary_matmul.cu", _dtypes(bf16),
        NTHREADS, (_cdiv(b, TILE), _cdiv(p, TILE)), 2 * TILE * (TILE + 1) * F32, 0,
        lookup=(0, 0, _dtype_code(bf16), 0, 0, 0))


def _tm_sparse_bytes(bm: int, bp: int) -> int:
    ld = bm + 1   # ys[PT][32 RL + 1], xs[8][32][32 RL + 1], queue[8][64]
    return (bp * ld + FT_WARPS * 32 * ld) * F32 + FT_WARPS * FT_QUEUE * 4


def ternary_matmul_sparse_estimate(b: int, m: int, p: int, *, block_m: int = 64,
                                   block_p: int = 64, bf16: bool = False,
                                   sms: int = H100_SMS) -> KernelEstimate:
    """ternary_matmul.cu `ternary_matmul_sparse_kernel<TX, RL, PT>`: 8 warps,
    32 RL rows of x and at most PT rows of R a CTA; TmSmem is dynamic."""
    bm, bp = block_m, block_p
    return KernelEstimate(
        "ternary_matmul_sparse_kernel", "ternary_matmul.cu",
        f"{_dtypes(bf16)},RL={bm // 32},PT={bp}",
        FT_THREADS, (_cdiv(b, bm), ft_p_tiles(b, p, sms, bp, bm)), 0, _tm_sparse_bytes(bm, bp),
        min_ctas=2, lookup=(0, 1, _dtype_code(bf16), bm, bp, 0))


FT_DN = 64           # fused_transform.cu
FT_BCAP = 4224
FT_NC = 64
FT_SUM_THREADS = 256


def fused_transform_dense_estimate(rows: int, m: int, p: int, n: int, *,
                                   bf16: bool = False, b_bf16: Optional[bool] = None
                                   ) -> KernelEstimate:
    """fused_transform.cu `fused_transform_dense_kernel`: 16 x 16 threads, 32
    rows x 64 output columns a CTA; xs, rs, ys [32][33] and bs [32][65] f32."""
    static = (3 * TILE * (TILE + 1) + TILE * (FT_DN + 1)) * F32
    return KernelEstimate(
        "fused_transform_dense_kernel", "fused_transform.cu", _dtypes(bf16, b_bf16),
        NTHREADS, (_cdiv(rows, TILE), _cdiv(n, FT_DN)), static, 0,
        lookup=(1, 0, _dtype_code(bf16), _dtype_code(_or(b_bf16, bf16)), 0, 0))


def _ft_sparse_bytes(bm: int, bp: int) -> int:
    # ys[PT][32 RL], xs[8][32][32 RL + 1], queue[8][64], bs[4224 + 64]
    return (bp * bm + FT_WARPS * 32 * (bm + 1) + FT_BCAP + FT_NC) * F32 + FT_WARPS * FT_QUEUE * 4


def fused_transform_sparse_estimate(rows: int, m: int, p: int, n: int, *, block_m: int = 64,
                                    block_p: int = 64, bf16: bool = False,
                                    b_bf16: Optional[bool] = None,
                                    sms: int = H100_SMS) -> KernelEstimate:
    """fused_transform.cu `fused_transform_kernel<TX, TB, RL, PT>`: 8 warps,
    32 RL rows of x and at most PT rows of R a CTA; FtSmem is dynamic."""
    bm, bp = block_m, block_p
    return KernelEstimate(
        "fused_transform_kernel", "fused_transform.cu",
        f"{_dtypes(bf16, b_bf16)},RL={bm // 32},PT={bp}", FT_THREADS,
        (_cdiv(rows, bm), ft_p_tiles(rows, p, sms, bp, bm)), 0, _ft_sparse_bytes(bm, bp),
        min_ctas=2, lookup=(1, 1, _dtype_code(bf16), _dtype_code(_or(b_bf16, bf16)), bm, bp))


def fused_transform_sum_estimate(rows: int, n: int, *, bf16: bool = False) -> KernelEstimate:
    """fused_transform.cu `fused_transform_sum_kernel<TB>`: one thread an
    output, the partials in registers."""
    return KernelEstimate(
        "fused_transform_sum_kernel", "fused_transform.cu", _dtypes(bf16),
        FT_SUM_THREADS, (_cdiv(rows * n, FT_SUM_THREADS),), 0, 0,
        lookup=(1, 2, 0, _dtype_code(bf16), 0, 0))


ES_SMALL_N = 64      # easi_update.cu
ES_SMALL_WORK = 1 << 17
ES_MAX_SLICES = 8
ES_SLICE_MIN = 32
ES_UT = 16
TK_GRAM = 32
ES_KC = 128
ES_KSPLIT = NTHREADS // (ES_UT * ES_UT // 4)
EASI_SMALL_COLS = (32, 64, 128)   # small body: columns of B a CTA (template CT)
EASI_SPLIT_COLS = (16, 32, 64)    # split body's update: columns of its 16-row tile (UC)


def effective_easi_tile(b: int, n: int, m: int, block_m: int = 512,
                        sms: int = H100_SMS) -> int:
    """The columns of B one CTA of B2 updates for an `Execution`'s
    `easi_block_m` on y (b, n), B (n, m), as `repro_easi_apply_plan` maps
    it: among the templates of the body the call takes, a `block_m` that
    names one runs it; any other (the reference's Pallas sizes, the
    policy's default 512 among them) runs the narrowest; then no wider than
    the narrowest template that holds m."""
    cols = EASI_SMALL_COLS if easi_slices(b, n, sms) == 0 else EASI_SPLIT_COLS
    bm = block_m if block_m in cols else cols[0]
    return min(bm, min(t for t in cols if t >= min(m, cols[-1])))


def easi_small_estimate(b: int, n: int, m: int, *, cols: int = EASI_SMALL_COLS[0],
                        bf16: bool = False, b_bf16: Optional[bool] = None) -> KernelEstimate:
    """easi_small.cuh `easi_small_kernel<NA, CT, TY, TB>`: 16 x 16 threads,
    CT columns of B a CTA; ys, gys [32][64], gs [64][65] f32 static, bs
    [16 NA][CT + 1] f32 dynamic."""
    na = min(4, _cdiv(n, 16))
    static = (2 * 32 * ES_SMALL_N + ES_SMALL_N * (ES_SMALL_N + 1)) * F32
    return KernelEstimate(
        "easi_small_kernel", "easi_small.cuh", f"{_dtypes(bf16, b_bf16)},NA={na},CT={cols}",
        NTHREADS, (_cdiv(m, cols),), static, 16 * na * (cols + 1) * F32,
        lookup=(2, 0, _dtype_code(bf16), _dtype_code(_or(b_bf16, bf16)), na, cols))


def easi_slices(b: int, n: int, sms: int = H100_SMS) -> int:
    """`repro_easi_apply_plan`: 0 for the small body, else the split body's
    sample slices (one cluster a tile of G)."""
    if n <= ES_SMALL_N and b * n * n <= ES_SMALL_WORK:
        return 0
    tiles = _cdiv(n, TILE) ** 2
    slices = min(ES_MAX_SLICES, min(_cdiv(sms, tiles), _cdiv(b, ES_SLICE_MIN)))
    return _cdiv(b, _cdiv(b, max(slices, 1)))


def easi_gram_estimate(b: int, n: int, *, bf16: bool = False,
                       sms: int = H100_SMS) -> KernelEstimate:
    """easi_update.cu `easi_gram_kernel<TY>`: 16 x 16 threads a (32 x 32 tile
    of G, slice of samples); the slices of a tile form one cluster; yi, yj,
    gi [32][33] and recv [2 * 32 * 32 + 8] f32."""
    slices = max(1, easi_slices(b, n, sms))
    static = (3 * TK_GRAM * (TILE + 1) + 2 * TILE * TILE + ES_MAX_SLICES) * F32
    return KernelEstimate(
        "easi_gram_kernel", "easi_update.cu", _dtypes(bf16), NTHREADS,
        (_cdiv(n, TILE), _cdiv(n, TILE), slices), static, 0, cluster=slices,
        lookup=(2, 1, _dtype_code(bf16), 0, 0, 0))



def easi_update_estimate(n: int, m: int, *, cols: int = EASI_SPLIT_COLS[0],
                         bf16: bool = False) -> KernelEstimate:
    """easi_update.cu `easi_update_kernel<UC, TB>`: 256 threads a 16 x UC
    tile of the new B; ss, hs [16][129], gs [128][17], red [4][16][UC + 1]
    f32 static, bs [128][UC + 1] f32 dynamic."""
    static = (2 * ES_UT * (ES_KC + 1) + ES_KC * (ES_UT + 1)
              + ES_KSPLIT * ES_UT * (cols + 1)) * F32
    return KernelEstimate(
        "easi_update_kernel", "easi_update.cu", f"{_dtypes(bf16)},UC={cols}", NTHREADS,
        (_cdiv(n, ES_UT), _cdiv(m, cols)), static, ES_KC * (cols + 1) * F32,
        lookup=(2, 2, 0, _dtype_code(bf16), 0, cols))


FA_BQ = FA_BK = 64   # flash_attention.cu
TC_WARPS = 8
TC_BK = 64
TC_PAD = 8


FLASH_TC_TILES = (64, 128, 224)   # the bf16 forward's Dh tiles; the f32 one stops at 128


def _flash_tile(dh: int) -> int:
    return 64 if dh <= 64 else 128 if dh <= 128 else 224


def _flash_tc_smem(d: int) -> int:
    """The bf16 forward's dynamic shared memory: two K / V buffers of 64 rows
    of D + 8 bf16, and above D 128 Q's own 128 rows beside them (D 224:
    178 176 bytes, 250 registers a thread and no spill on an H100 80GB HBM3,
    `chip_smoke.py --only resources`)."""
    return 2 * (4 * TC_BK + (16 * TC_WARPS if d > 128 else 0)) * (d + TC_PAD)


def flash_fma_estimate(batch: int, sq: int, skv: int, hq: int, hkv: int, dh: int
                       ) -> KernelEstimate:
    """flash_attention.cu `flash_attention_kernel<float, DH>` (f32): 16 x 16
    threads a (batch, head, 64-row query tile); q, k tiles [64][DH + 1], v
    [64][DH], p [64][65] f32, dynamic."""
    d = _flash_tile(dh)
    dyn = (FA_BQ * (d + 1) + FA_BK * (d + 1) + FA_BK * d + FA_BQ * (FA_BK + 1)) * F32
    return KernelEstimate(
        "flash_attention_kernel", "flash_attention.cu", f"f32,DH={d}", 256,
        (_cdiv(sq, FA_BQ), batch * hq), 0, dyn, lookup=(3, 0, d, 0, 0, 0))


def _flash_tc_blocks(batch: int, sq: int, hq: int, hkv: int) -> int:
    """The CTAs of the forward's bf16 grid (and of the backward's pass 1):
    128 rows a CTA, of hg query heads of one kv head, hg the largest power
    of two <= 8 that divides Hq / Hkv."""
    grp = hq // hkv
    hg = 1
    while hg * 2 <= TC_WARPS and grp % (hg * 2) == 0:
        hg *= 2
    return _cdiv(sq, 16 * TC_WARPS // hg) * batch * hkv * (grp // hg)


def flash_tc_estimate(batch: int, sq: int, skv: int, hq: int, hkv: int, dh: int, *,
                      vec: bool = True) -> KernelEstimate:
    """flash_attention.cu `flash_tc_kernel<D, VEC>` (bf16): 8 warps a 128-row
    query tile of hg heads of one kv head; two K / V buffers of 64 rows of
    D + 8 bf16, and at D 224 the Q tile's 128 rows, dynamic."""
    d = _flash_tile(dh)
    return KernelEstimate(
        "flash_tc_kernel", "flash_attention.cu", f"bf16,D={d},VEC={int(vec)}", 32 * TC_WARPS,
        (_flash_tc_blocks(batch, sq, hq, hkv),), 0, _flash_tc_smem(d),
        lookup=(3, 1, d, int(vec), 0, 0))


BW_KEYS = 16 * TC_WARPS   # flash_attention_bwd.cu: keys a pass-2 CTA
BW_BQ = 64                # and query rows a pass-2 tile
BWD_TILES = (16, 32, 48, 64, 80, 96, 112, 128)   # Dh rounded up to a multiple of 16


def _bwd_tile(dh: int) -> int:
    return _cdiv(dh, 16) * 16


def flash_bwd_dq_estimate(batch: int, sq: int, skv: int, hq: int, hkv: int, dh: int
                          ) -> KernelEstimate:
    """flash_attention_bwd.cu `flash_bwd_dq_kernel<D>` (bf16, pass 1): the
    forward's CTAs; two K / V buffers of 64 rows of D + 8 bf16 (Q and dO
    staged in them first), dynamic."""
    d = _bwd_tile(dh)
    return KernelEstimate(
        "flash_bwd_dq_kernel", "flash_attention_bwd.cu", f"bf16,D={d}", 32 * TC_WARPS,
        (_flash_tc_blocks(batch, sq, hq, hkv),), 0, 2 * 4 * TC_BK * (d + TC_PAD),
        lookup=(4, 0, d, 0, 0, 0))


def flash_bwd_dkdv_estimate(batch: int, sq: int, skv: int, hq: int, hkv: int, dh: int
                            ) -> KernelEstimate:
    """flash_attention_bwd.cu `flash_bwd_dkdv_kernel<D>` (bf16, pass 2): 8
    warps a (batch, kv head, 128 keys); K and V tiles of 128 rows and two
    buffers of a Q and a dO tile of 64 rows, all of D + 8 bf16, and two
    buffers of 64 lse and delta f32, dynamic."""
    d = _bwd_tile(dh)
    dyn = 2 * (2 * BW_KEYS + 4 * BW_BQ) * (d + TC_PAD) + F32 * 4 * BW_BQ
    return KernelEstimate(
        "flash_bwd_dkdv_kernel", "flash_attention_bwd.cu", f"bf16,D={d}", 32 * TC_WARPS,
        (_cdiv(skv, BW_KEYS) * batch * hkv,), 0, dyn, lookup=(4, 1, d, 0, 0, 0))


# ---- the bodies a call launches (the wrappers' plan / tiles) ------------------------

def ternary_matmul_call(b: int, m: int, p: int, *, block_m: int = 128, block_p: int = 128,
                        bf16: bool = False,
                        sms: int = H100_SMS) -> List[KernelEstimate]:
    if p * m < DENSE_MAX_R:
        return [ternary_matmul_dense_estimate(b, m, p, bf16=bf16)]
    bm, bp = effective_tiles(b, p, m, block_m, block_p)
    return [ternary_matmul_sparse_estimate(b, m, p, block_m=bm, block_p=bp, bf16=bf16, sms=sms)]


def fused_transform_call(rows: int, m: int, p: int, n: int, *, block_m: int = 128,
                         block_p: int = 128, bf16: bool = False,
                         sms: int = H100_SMS) -> List[KernelEstimate]:
    if p * m < DENSE_MAX_R:
        return [fused_transform_dense_estimate(rows, m, p, n, bf16=bf16)]
    bm, bp = effective_tiles(rows, p, m, block_m, block_p)
    main = fused_transform_sparse_estimate(rows, m, p, n, block_m=bm, block_p=bp, bf16=bf16,
                                           sms=sms)
    return [main] + ([fused_transform_sum_estimate(rows, n, bf16=bf16)]
                     if main.grid[1] > 1 else [])


def easi_apply_call(b: int, n: int, m: int, *, block_m: int = 512, bf16: bool = False,
                    sms: int = H100_SMS) -> List[KernelEstimate]:
    cols = effective_easi_tile(b, n, m, block_m, sms)
    if easi_slices(b, n, sms) == 0:
        return [easi_small_estimate(b, n, m, cols=cols, bf16=bf16)]
    return [easi_gram_estimate(b, n, bf16=bf16, sms=sms),
            easi_update_estimate(n, m, cols=cols, bf16=bf16)]


def flash_attention_call(batch: int, sq: int, skv: int, hq: int, hkv: int, dh: int, *,
                         bf16: bool = True) -> List[KernelEstimate]:
    if bf16:
        return [flash_tc_estimate(batch, sq, skv, hq, hkv, dh, vec=dh % 8 == 0)]
    return [flash_fma_estimate(batch, sq, skv, hq, hkv, dh)]


def flash_attention_bwd_call(batch: int, sq: int, skv: int, hq: int, hkv: int, dh: int
                             ) -> List[KernelEstimate]:
    return [flash_bwd_dq_estimate(batch, sq, skv, hq, hkv, dh),
            flash_bwd_dkdv_estimate(batch, sq, skv, hq, hkv, dh)]


# every __global__ in csrc/ -> its estimator; tests/test_torch_resources.py
# parses the sources and fails on a body without an entry or an entry
# without a body
MODELED_KERNELS: Dict[str, Callable[..., KernelEstimate]] = {
    "ternary_matmul_dense_kernel": ternary_matmul_dense_estimate,
    "ternary_matmul_sparse_kernel": ternary_matmul_sparse_estimate,
    "fused_transform_dense_kernel": fused_transform_dense_estimate,
    "fused_transform_kernel": fused_transform_sparse_estimate,
    "fused_transform_sum_kernel": fused_transform_sum_estimate,
    "easi_small_kernel": easi_small_estimate,
    "easi_gram_kernel": easi_gram_estimate,
    "easi_update_kernel": easi_update_estimate,
    "flash_attention_kernel": flash_fma_estimate,
    "flash_tc_kernel": flash_tc_estimate,
    "flash_bwd_dq_kernel": flash_bwd_dq_estimate,
    "flash_bwd_dkdv_kernel": flash_bwd_dkdv_estimate,
}

# the shapes of the report: the reference's paper-scale rows (m = 32, p = 16,
# n = 8 under the largest bucket; flash at (1, 1024, 1024, 8, 8, 64)), the
# repo's wide row (256, 1024, 256, 128) and flash, forward and backward, at
# chip_smoke.py's request A (4 x 1024, 32 / 8 heads, Dh 120, bf16)
PAPER_ROW = dict(rows=1024, m=32, p=16, n=8)
WIDE_ROW = dict(rows=256, m=1024, p=256, n=128)
REQUEST_A = dict(batch=4, sq=1024, skv=1024, hq=32, hkv=8, dh=120)
ZAMBA_PREFILL = dict(batch=1, sq=4096, skv=4096, hq=32, hkv=32, dh=224)


def paper_scale_report(sms: int = H100_SMS) -> List[KernelEstimate]:
    """Every body at the shapes the repo runs it at, each sparse tile
    template and each of B2's column templates at the wide row; twelve
    bodies in all."""
    pr, wr = PAPER_ROW, WIDE_ROW
    out = fused_transform_call(pr["rows"], pr["m"], pr["p"], pr["n"], sms=sms)
    out += ternary_matmul_call(pr["rows"], pr["m"], pr["p"], sms=sms)
    out += easi_apply_call(pr["rows"], pr["n"], pr["p"], sms=sms)
    for bm in TILE_ROWS:
        for bp in TILE_P:
            out += fused_transform_call(wr["rows"], wr["m"], wr["p"], wr["n"], block_m=bm,
                                        block_p=bp, sms=sms)
            out += ternary_matmul_call(wr["rows"], wr["m"], wr["p"], block_m=bm, block_p=bp,
                                       sms=sms)
    for cols in EASI_SPLIT_COLS:
        out += easi_apply_call(wr["rows"], wr["n"], wr["p"], block_m=cols, sms=sms)
    out += flash_attention_call(1, 1024, 1024, 8, 8, 64, bf16=False)
    out += flash_attention_call(**REQUEST_A, bf16=True)
    out += flash_attention_call(**ZAMBA_PREFILL, bf16=True)
    out += flash_attention_bwd_call(**REQUEST_A)
    seen, uniq = set(), []
    for est in out:                        # the sum kernel comes once per tile point
        if est not in seen:
            seen.add(est)
            uniq.append(est)
    return uniq


def every_instance(sms: int = H100_SMS) -> List[KernelEstimate]:
    """One estimate for every template instance the sources compile (each
    dtype pair, tile template, NA, column template, Dh tile and load path),
    at the report's shapes: what `chip_smoke.py`'s `[resources]` holds
    against the card."""
    pr, wr = PAPER_ROW, WIDE_ROW
    out: List[KernelEstimate] = []
    for x16 in (False, True):
        out.append(ternary_matmul_dense_estimate(pr["rows"], pr["m"], pr["p"], bf16=x16))
        for bm in TILE_ROWS:
            for bp in TILE_P:
                out.append(ternary_matmul_sparse_estimate(wr["rows"], wr["m"], wr["p"], block_m=bm,
                                                          block_p=bp, bf16=x16, sms=sms))
        out.append(fused_transform_sum_estimate(wr["rows"], wr["n"], bf16=x16))
        out.append(easi_gram_estimate(wr["rows"], wr["n"], bf16=x16, sms=sms))
        for cols in EASI_SPLIT_COLS:
            out.append(easi_update_estimate(wr["n"], wr["p"], cols=cols, bf16=x16))
        for b16 in (False, True):
            out.append(fused_transform_dense_estimate(pr["rows"], pr["m"], pr["p"], pr["n"],
                                                      bf16=x16, b_bf16=b16))
            for bm in TILE_ROWS:
                for bp in TILE_P:
                    out.append(fused_transform_sparse_estimate(
                        wr["rows"], wr["m"], wr["p"], wr["n"], block_m=bm, block_p=bp, bf16=x16,
                        b_bf16=b16, sms=sms))
            for na in range(1, 5):
                for cols in EASI_SMALL_COLS:
                    out.append(easi_small_estimate(32, 16 * na, 24, cols=cols, bf16=x16,
                                                   b_bf16=b16))
    for dh in (64, 128):
        out.append(flash_fma_estimate(1, 1024, 1024, 8, 8, dh))
        for vec in (False, True):
            out.append(flash_tc_estimate(**REQUEST_A, vec=vec) if dh == 128 else
                       flash_tc_estimate(1, 1024, 1024, 8, 8, 64, vec=vec))
    for vec in (False, True):            # Zamba2's shared block: 1 x 4096, 32 / 32 heads of 224
        out.append(flash_tc_estimate(**ZAMBA_PREFILL, vec=vec))
    for d in BWD_TILES:
        out += flash_attention_bwd_call(**dict(REQUEST_A, dh=d))
    return out


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.kernels.resource_model",
        description="per-launch resources of the port's CUDA kernel bodies on the H100")
    ap.add_argument("--json", metavar="FILE", help="write the report rows to FILE")
    args = ap.parse_args(argv)
    estimates = paper_scale_report()
    problems: List[str] = []
    for est in estimates:
        problems.extend(est.validate())
        print(f"{est.kernel + '<' + est.variant + '>':<44} threads={est.threads:<4} "
              f"grid={str(est.grid):<14} smem static={est.static_smem:>6} "
              f"dynamic={est.dynamic_smem:>6} regs<={est.reg_ceiling:<3} "
              f"cluster={est.cluster} ctas/SM={est.ctas_per_sm}")
    if args.json:
        with open(args.json, "w", encoding="utf-8") as f:
            json.dump([est.to_row() for est in estimates], f, indent=2)
            f.write("\n")
    for p in problems:
        print(f"VIOLATION: {p}", file=sys.stderr)
    return 1 if problems else 0


if __name__ == "__main__":
    sys.exit(main())
