"""The order of XLA's unstable sort on the CPU, for parity on the CPU.

The JAX package's exact grower sorts each feature's rows with
``lax.sort(is_stable=False)``; on the CPU XLA runs libstdc++'s
``std::sort`` (introsort), which leaves rows of equal keys in an order of
its own.  The prefix sums that follow add those rows in that order, so
the bits of every boundary sum, and the near-ties they decide, follow
it.  :func:`unstable_sort_order` replays the algorithm: median-of-three
quicksort partitions (each one vectorized), a heap sort below twice
log2(N) levels of recursion, and the final insertion sort, which is a
stable sort of the partitioned array.
"""

from __future__ import annotations

import numpy as np

_THRESHOLD = 16     # libstdc++'s _S_threshold


def _heap_sort(a: np.ndarray, key: np.ndarray, first: int,
               last: int) -> None:
    """libstdc++'s ``std::__partial_sort(first, last, last)`` on
    ``a[first:last]``: make_heap, then sort_heap, compared by ``key``."""
    n = last - first

    def adjust(hole, length, v):
        top = child = hole
        while child < (length - 1) // 2:
            child = 2 * (child + 1)
            if key[a[first + child]] < key[a[first + child - 1]]:
                child -= 1
            a[first + hole] = a[first + child]
            hole = child
        if length % 2 == 0 and child == (length - 2) // 2:
            child = 2 * (child + 1)
            a[first + hole] = a[first + child - 1]
            hole = child - 1
        parent = (hole - 1) // 2
        while hole > top and key[a[first + parent]] < key[v]:
            a[first + hole] = a[first + parent]
            hole = parent
            parent = (hole - 1) // 2
        a[first + hole] = v

    for parent in range((n - 2) // 2, -1, -1):
        adjust(parent, n, a[first + parent])
    for length in range(n - 1, 0, -1):
        v = a[first + length]
        a[first + length] = a[first]
        adjust(0, length, v)


def unstable_sort_order(key: np.ndarray) -> np.ndarray:
    """The permutation that ``std::sort`` applies to ``key`` (N,), ties
    included: ``key[order]`` is sorted."""
    n = len(key)
    a = np.arange(n)
    if n <= 1:
        return a
    stack = [(0, n, 2 * (n.bit_length() - 1))]
    while stack:
        first, last, depth = stack.pop()
        while last - first > _THRESHOLD:
            if depth == 0:
                _heap_sort(a, key, first, last)
                break
            depth -= 1
            # the median of a[first + 1], a[mid], a[last - 1] to the front
            mid = first + (last - first) // 2
            A, B, C = key[a[first + 1]], key[a[mid]], key[a[last - 1]]
            if A < B:
                m = mid if B < C else (last - 1 if A < C else first + 1)
            else:
                m = first + 1 if A < C else (last - 1 if B < C else mid)
            a[first], a[m] = a[m], a[first]
            # Hoare partition around it: the left pointer's stops are the
            # slots >= pivot, the right pointer's those <= pivot, swapped
            # in pairs until they cross
            pv = key[a[first]]
            seg = key[a[first + 1:last]]
            lo = np.flatnonzero(seg >= pv) + first + 1
            hi = np.flatnonzero(seg <= pv)[::-1] + first + 1
            t = min(len(lo), len(hi))
            cross = np.flatnonzero(lo[:t] >= hi[:t])
            s = int(cross[0]) if len(cross) else t
            a[lo[:s]], a[hi[:s]] = a[hi[:s]], a[lo[:s]].copy()
            # the left pointer ends at its next stop, or at the slot the
            # last swap filled, whichever comes first
            cut = int(lo[s]) if s < len(lo) and (s == 0 or lo[s] < hi[s - 1]) \
                else int(hi[s - 1])
            stack.append((cut, last, depth))
            last = cut
    return a[np.argsort(key[a], kind="stable")]


def float_sort_key(x: np.ndarray) -> np.ndarray:
    """int64 keys that order f32 values as ``lax.sort`` compares them:
    -0.0 equals 0.0, every NaN is one value above +inf."""
    x = np.where(x == 0, np.float32(0), x).astype(np.float32)
    x = np.where(np.isnan(x), np.float32(np.nan), x).astype(np.float32)
    bits = x.view(np.int32).astype(np.int64)
    return np.where(bits < 0, (2 ** 31 - 1) - bits - 2 ** 32, bits)
