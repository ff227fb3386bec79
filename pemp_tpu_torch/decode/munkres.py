"""Classical Munkres (Hungarian) assignment on the host (copy of
pemp_tpu.decode.munkres, which the port may not import).

The reference's AE grouping uses the ``munkres`` PyPI package
(reference: src/Utils/hr_utils/group.py:13,35-39 py_max_match and
src/Utils/Utils.py mpn_match_by_tag), and its tie-breaking between equally
optimal assignments is load-bearing: the ``round(d)*100 - score`` cost
form produces tied optima constantly. This is the classical 6-step
algorithm (Munkres 1957) with the package's deterministic step structure:
pad to square with zeros, row-reduce, greedy row-major zero starring,
column covering, prime/augment with wrap-around zero scanning. Nothing is
random or hash-ordered, so its tie order is stable; the CPU tests hold it
to the JAX package's copy exactly.
"""

from __future__ import annotations

import numpy as np


class UnsolvableMatrix(Exception):
    """Raised when step 6 cannot make progress (degenerate input)."""


class Munkres:
    """Drop-in for ``munkres.Munkres``: ``compute(cost)`` -> [(row, col)].

    Accepts rectangular matrices (padded internally to square with zeros);
    the returned pairs are restricted to the original dimensions, matching
    the PyPI package's contract.
    """

    def compute(self, cost_matrix):
        C = np.array(cost_matrix, copy=True)
        # The PyPI package computes in exact python ints; float64 would
        # destroy differences between huge integer costs (the package's own
        # documented profit example uses sys.maxsize - profit, whose
        # pairwise differences are far below 2**63's ulp). Integer inputs
        # therefore stay int64: every operation here is add/sub/min/==0,
        # exact in int64, and after the step-1 row reduction all values are
        # bounded by the per-row spread, so no overflow accumulates.
        dtype = np.int64 if C.dtype.kind in "iu" else np.float64
        C = C.astype(dtype)
        if C.ndim != 2 or C.size == 0:
            return []
        orig_rows, orig_cols = C.shape
        n = max(orig_rows, orig_cols)
        if C.shape != (n, n):
            sq = np.zeros((n, n), dtype)
            sq[:orig_rows, :orig_cols] = C
            C = sq
        self.C = C
        self.n = n
        self.row_covered = np.zeros(n, bool)
        self.col_covered = np.zeros(n, bool)
        self.marked = np.zeros((n, n), np.int8)  # 1 = starred, 2 = primed
        self.Z0_r = 0
        self.Z0_c = 0
        self.path = np.zeros((2 * n, 2), np.int64)

        step = 1
        steps = {
            1: self._step1, 2: self._step2, 3: self._step3,
            4: self._step4, 5: self._step5, 6: self._step6,
        }
        # generous progress bound: each step-6 reduction exposes >=1 new
        # zero; float pathologies (costs whose differences never cancel
        # exactly) could otherwise loop forever
        budget = 100 * n * n + 1000
        while step in steps:
            step = steps[step]()
            budget -= 1
            if budget <= 0:
                raise UnsolvableMatrix("no convergence (degenerate floats?)")

        return [
            (i, j)
            for i in range(orig_rows)
            for j in range(orig_cols)
            if self.marked[i, j] == 1
        ]

    # -- steps -----------------------------------------------------------
    def _step1(self):
        # subtract each row's minimum from the row
        self.C -= self.C.min(axis=1, keepdims=True)
        return 2

    def _step2(self):
        # star the first uncovered zero of each row, row-major greedy
        n = self.n
        for i in range(n):
            for j in range(n):
                if (
                    self.C[i, j] == 0
                    and not self.col_covered[j]
                    and not self.row_covered[i]
                ):
                    self.marked[i, j] = 1
                    self.col_covered[j] = True
                    self.row_covered[i] = True
                    break
        self._clear_covers()
        return 3

    def _step3(self):
        # cover every column containing a starred zero
        starred_cols = (self.marked == 1).any(axis=0)
        self.col_covered |= starred_cols
        return 7 if int(self.col_covered.sum()) >= self.n else 4

    def _step4(self):
        # prime uncovered zeros; on a primed zero with no star in its row,
        # go augment (step 5); with a star, cover the row / uncover the
        # star's column and keep scanning from the current position
        row = col = 0
        while True:
            row, col = self._find_a_zero(row, col)
            if row < 0:
                return 6
            self.marked[row, col] = 2
            star_col = self._find_star_in_row(row)
            if star_col >= 0:
                col = star_col
                self.row_covered[row] = True
                self.col_covered[col] = False
            else:
                self.Z0_r, self.Z0_c = row, col
                return 5

    def _step5(self):
        # alternating star/prime path from Z0; flip stars along the path
        count = 0
        path = self.path
        path[count] = (self.Z0_r, self.Z0_c)
        while True:
            row = self._find_star_in_col(path[count][1])
            if row < 0:
                break
            count += 1
            path[count] = (row, path[count - 1][1])
            col = self._find_prime_in_row(path[count][0])
            count += 1
            path[count] = (path[count - 1][0], col)
        for i in range(count + 1):
            r, c = path[i]
            self.marked[r, c] = 0 if self.marked[r, c] == 1 else 1
        self._clear_covers()
        self.marked[self.marked == 2] = 0  # erase primes
        return 3

    def _step6(self):
        # add the smallest uncovered value to covered rows, subtract it
        # from uncovered columns
        uncovered = ~self.row_covered[:, None] & ~self.col_covered[None, :]
        if not uncovered.any():
            raise UnsolvableMatrix("matrix cannot be solved")
        minval = self.C[uncovered].min()
        if minval == 0:
            raise UnsolvableMatrix("no progress in step 6")
        self.C[self.row_covered, :] += minval
        self.C[:, ~self.col_covered] -= minval
        return 4

    # -- helpers ---------------------------------------------------------
    def _clear_covers(self):
        self.row_covered[:] = False
        self.col_covered[:] = False

    def _find_a_zero(self, i0, j0):
        # wrap-around scan from (i0, j0), as in the classical formulation:
        # rows from i0, columns from j0 within each row; the scan of a row
        # completes even after a hit (the last uncovered zero of the first
        # hit row wins) — this matches the munkres package's scan quirk,
        # which is part of its deterministic tie order
        n = self.n
        row = col = -1
        i = i0
        while True:
            j = j0
            while True:
                if (
                    self.C[i, j] == 0
                    and not self.row_covered[i]
                    and not self.col_covered[j]
                ):
                    row, col = i, j
                j = (j + 1) % n
                if j == j0:
                    break
            if row >= 0:
                return row, col
            i = (i + 1) % n
            if i == i0:
                return -1, -1

    def _find_star_in_row(self, row):
        js = np.nonzero(self.marked[row] == 1)[0]
        return int(js[0]) if len(js) else -1

    def _find_star_in_col(self, col):
        is_ = np.nonzero(self.marked[:, col] == 1)[0]
        return int(is_[0]) if len(is_) else -1

    def _find_prime_in_row(self, row):
        js = np.nonzero(self.marked[row] == 2)[0]
        return int(js[0]) if len(js) else -1


def min_cost_pairs(cost: np.ndarray) -> np.ndarray:
    """Complete min-cost assignment as an (k, 2) int array of row/col pairs."""
    if cost.size == 0:
        return np.zeros((0, 2), np.int32)
    pairs = Munkres().compute(np.asarray(cost, np.float64))
    if not pairs:
        return np.zeros((0, 2), np.int32)
    return np.asarray(pairs, np.int32)
