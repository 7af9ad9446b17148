"""The work of kernel K1's problem, counted from its shape alone and not
from the algorithm that solves it, so that a solver swapped for another
leaves the bound where it is.

A launch solves B independent symmetric block-tridiagonal systems of N
block rows of k x k (k = 9): D (B, N, k, k), U (B, N-1, k, k), the
right-hand side b (B, N, k) and the solution x (B, N, k).

Bytes: each input block read once and the solution written once,

    bytes = e B (k^2 N + k^2 (N - 1) + 2 k N),  e = 8 (f64) or 4 (f32).

Operations: the block Thomas elimination, the least a direct solve of the
system needs.  For each block row t (a multiply-add counts two):

    Schur update of the pivot block  D_t - L_t C_{t-1}:   2k^3 + k^2
    update of the right-hand side    b_t - L_t d_{t-1}:   2k^2 + k
    LU of the pivot block:                                 (2/3) k^3
    its solve for [U_t | b_t] (k + 1 columns):             2k^2 (k + 1)
    back substitution            x_t = d_t - C_t x_{t+1}:  2k^2 + k

so flops = B N (2k^3 + (2/3)k^3 + 2k^2 (k+1) + k^2 + 4k^2 + 2k), counting
the first row's Schur update (which is absent) and the last row's U
(also absent) as if present: at N = 448 they change the count by 0.4%.
At (B, N, k) = (9, 448, 9) in f64 that is 16.1 MFLOP and 5.80 MB, so
the bytes bound it: 1.73 us at 3.35 TB/s against 0.24 us at 67 TFLOP/s.
"""
from benchmark.metrics import peaks

K = 9
_ELEM = {"float64": 8, "float32": 4}


def bytes_moved(B: int, N: int, dtype: str, k: int = K) -> float:
    return float(_ELEM[dtype] * B * (k * k * N + k * k * (N - 1) + 2 * k * N))


def flops(B: int, N: int, k: int = K) -> float:
    per_row = (2 * k**3 + (2.0 / 3.0) * k**3 + 2 * k**2 * (k + 1) + k**2
               + 4 * k**2 + 2 * k)
    return float(B * N * per_row)


def min_seconds(B: int, N: int, dtype: str) -> float:
    """The least time the card could take: the larger of the operations
    over the peak rate and the bytes over the peak bandwidth."""
    return max(flops(B, N) / peaks.FLOPS[dtype],
               bytes_moved(B, N, dtype) / peaks.BYTES_PER_S)


def bound_by(B: int, N: int, dtype: str) -> str:
    return ("bytes" if bytes_moved(B, N, dtype) / peaks.BYTES_PER_S
            >= flops(B, N) / peaks.FLOPS[dtype] else "operations")
