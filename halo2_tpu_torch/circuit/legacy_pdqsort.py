"""Port of the Rust 1.56.1 unstable slice sort (pdqsort), fixed to its
64-bit behaviour — the `halo2_legacy_pdqsort` crate that backs the
reference's `floor-planner-v1-legacy-pdqsort` feature
(halo2_proofs/src/circuit/floor_planner/v1/strategy.rs:222-230).

Layout is consensus-relevant (it changes the vk), and historical
circuits were laid out with `sort_unstable_by_key` — whose equal-key
order is an artifact of this exact algorithm. The port follows
rust-lang/rust 1.56.1 `library/core/src/slice/sort.rs` step for step
(insertion thresholds, ninther pivot selection, xorshift
break_patterns with the 64-bit two-word generator, BLOCK=128 cyclic
partitioning, heapsort fallback) so equal-key orderings reproduce the
legacy layouts. No byte-oracle for the crate is available offline; the
fidelity contract is the line-by-line correspondence documented here.

Copied unchanged from halo2_tpu/circuit/legacy_pdqsort.py: the port
keeps its own copy of every host module it needs and imports nothing of
halo2_tpu.
"""
from __future__ import annotations

MAX_INSERTION = 20
MAX_STEPS = 5
SHORTEST_SHIFTING = 50
SHORTEST_MEDIAN_OF_MEDIANS = 50
MAX_SWAPS = 4 * 3
BLOCK = 128


def _shift_tail(v, lo, hi, less):
    """sort.rs shift_head's mirror: move v[hi-1] left while less than
    its predecessor (sort.rs `shift_tail`)."""
    if hi - lo >= 2 and less(v[hi - 1], v[hi - 2]):
        tmp = v[hi - 1]
        i = hi - 2
        v[i + 1] = v[i]
        while i > lo and less(tmp, v[i - 1]):
            v[i] = v[i - 1]
            i -= 1
        v[i] = tmp


def _shift_head(v, lo, hi, less):
    """Move v[lo] right while its successor is less (sort.rs
    `shift_head`)."""
    if hi - lo >= 2 and less(v[lo + 1], v[lo]):
        tmp = v[lo]
        i = lo + 1
        v[i - 1] = v[i]
        while i + 1 < hi and less(v[i + 1], tmp):
            v[i] = v[i + 1]
            i += 1
        v[i] = tmp


def _insertion_sort(v, lo, hi, less):
    for i in range(lo + 1, hi):
        _shift_tail(v, lo, i + 1, less)


def _heapsort(v, lo, hi, less):
    n = hi - lo

    def sift_down(end, node):
        while True:
            child = 2 * node + 1
            if child >= end:
                break
            if child + 1 < end and less(v[lo + child], v[lo + child + 1]):
                child += 1
            if not less(v[lo + node], v[lo + child]):
                break
            v[lo + node], v[lo + child] = v[lo + child], v[lo + node]
            node = child

    for i in range(n // 2 - 1, -1, -1):
        sift_down(n, i)
    for i in range(n - 1, 0, -1):
        v[lo], v[lo + i] = v[lo + i], v[lo]
        sift_down(i, 0)


def _partial_insertion_sort(v, lo, hi, less) -> bool:
    length = hi - lo
    i = 1
    for _ in range(MAX_STEPS):
        while i < length and not less(v[lo + i], v[lo + i - 1]):
            i += 1
        if i == length:
            return True
        if length < SHORTEST_SHIFTING:
            return False
        v[lo + i - 1], v[lo + i] = v[lo + i], v[lo + i - 1]
        _shift_tail(v, lo, lo + i, less)
        _shift_head(v, lo + i, hi, less)
    return False


def _break_patterns(v, lo, hi):
    """xorshift perturbation, 64-bit `gen_usize` (two u32 draws) —
    exactly the behaviour the legacy crate pins."""
    length = hi - lo
    if length >= 8:
        random = length & 0xFFFFFFFF

        def gen_u32():
            nonlocal random
            random ^= (random << 13) & 0xFFFFFFFF
            random ^= random >> 17
            random ^= (random << 5) & 0xFFFFFFFF
            return random

        def gen_usize():
            hi_w = gen_u32()
            lo_w = gen_u32()
            return ((hi_w << 32) | lo_w) & 0xFFFFFFFFFFFFFFFF

        modulus = 1 << (length - 1).bit_length()  # next_power_of_two
        pos = length // 4 * 2
        for i in range(3):
            other = gen_usize() & (modulus - 1)
            if other >= length:
                other -= length
            a, b = lo + pos - 1 + i, lo + other
            v[a], v[b] = v[b], v[a]


def _choose_pivot(v, lo, hi, less):
    length = hi - lo
    a = length // 4 * 1
    b = length // 4 * 2
    c = length // 4 * 3
    swaps = 0

    if length >= 8:
        def sort2(i, j):
            nonlocal swaps
            if less(v[lo + j], v[lo + i]):
                swaps += 1
                return j, i
            return i, j

        def sort3(i, j, k):
            i, j = sort2(i, j)
            j, k = sort2(j, k)
            i, j = sort2(i, j)
            return i, j, k

        if length >= SHORTEST_MEDIAN_OF_MEDIANS:
            def sort_adjacent(i):
                _, m, _ = sort3(i - 1, i, i + 1)
                return m

            a = sort_adjacent(a)
            b = sort_adjacent(b)
            c = sort_adjacent(c)

        a, b, c = sort3(a, b, c)

    if swaps < MAX_SWAPS:
        return b, swaps == 0
    # the slice is likely descending: reverse it
    v[lo:hi] = v[lo:hi][::-1]
    return length - 1 - b, True


def _partition_in_blocks(v, lo, hi, pivot, less) -> int:
    """sort.rs partition_in_blocks: branchless block partition with
    cyclic permutations (BLOCK = 128). Returns the number of elements
    less than the pivot."""
    l = lo
    block_l = BLOCK
    start_l = end_l = 0
    offsets_l = [0] * BLOCK

    r = hi
    block_r = BLOCK
    start_r = end_r = 0
    offsets_r = [0] * BLOCK

    base = lo

    while True:
        is_done = (r - l) <= 2 * BLOCK
        if is_done:
            rem = r - l
            if start_l < end_l or start_r < end_r:
                rem -= BLOCK
            if start_l < end_l:
                block_r = rem
            elif start_r < end_r:
                block_l = rem
            else:
                block_l = rem // 2
                block_r = rem - block_l

        if start_l == end_l:
            start_l = end_l = 0
            elem = l
            for i in range(block_l):
                offsets_l[end_l] = i
                if not less(v[elem], pivot):
                    end_l += 1
                elem += 1

        if start_r == end_r:
            start_r = end_r = 0
            elem = r
            for i in range(block_r):
                elem -= 1
                offsets_r[end_r] = i
                if less(v[elem], pivot):
                    end_r += 1

        count = min(end_l - start_l, end_r - start_r)
        if count > 0:
            # cyclic permutation between the two offset runs
            def left():
                return l + offsets_l[start_l]

            def right():
                return r - offsets_r[start_r] - 1

            tmp = v[left()]
            v[left()] = v[right()]
            for _ in range(1, count):
                start_l += 1
                v[right()] = v[left()]
                start_r += 1
                v[left()] = v[right()]
            v[right()] = tmp
            start_l += 1
            start_r += 1

        if start_l == end_l:
            l += block_l
        if start_r == end_r:
            r -= block_r
        if is_done:
            break

    if start_l < end_l:
        # the remaining block needs moving to the far right
        while start_l < end_l:
            end_l -= 1
            a, b = l + offsets_l[end_l], r - 1
            v[a], v[b] = v[b], v[a]
            r -= 1
        return r - base
    if start_r < end_r:
        while start_r < end_r:
            end_r -= 1
            a, b = l, r - offsets_r[end_r] - 1
            v[a], v[b] = v[b], v[a]
            l += 1
        return l - base
    return l - base


def _partition(v, lo, hi, pivot_idx, less):
    v[lo], v[lo + pivot_idx] = v[lo + pivot_idx], v[lo]
    pivot = v[lo]
    l = lo + 1
    r = hi
    while l < r and less(v[l], pivot):
        l += 1
    while l < r and not less(v[r - 1], pivot):
        r -= 1
    was_partitioned = l >= r
    mid = (l - (lo + 1)) + _partition_in_blocks(v, l, r, pivot, less)
    v[lo], v[lo + mid] = v[lo + mid], v[lo]
    return mid, was_partitioned


def _partition_equal(v, lo, hi, pivot_idx, less) -> int:
    v[lo], v[lo + pivot_idx] = v[lo + pivot_idx], v[lo]
    pivot = v[lo]
    l = lo + 1
    r = hi
    while True:
        while l < r and not less(pivot, v[l]):
            l += 1
        while l < r and less(pivot, v[r - 1]):
            r -= 1
        if l >= r:
            break
        r -= 1
        v[l], v[r] = v[r], v[l]
        l += 1
    return l - lo  # includes the pivot slot


def _recurse(v, lo, hi, less, pred, limit):
    was_balanced = True
    was_partitioned = True
    while True:
        length = hi - lo
        if length <= MAX_INSERTION:
            _insertion_sort(v, lo, hi, less)
            return
        if limit == 0:
            _heapsort(v, lo, hi, less)
            return
        if not was_balanced:
            _break_patterns(v, lo, hi)
            limit -= 1
        pivot_idx, likely_sorted = _choose_pivot(v, lo, hi, less)
        if was_balanced and was_partitioned and likely_sorted:
            if _partial_insertion_sort(v, lo, hi, less):
                return
        if pred is not None and not less(pred, v[lo + pivot_idx]):
            mid = _partition_equal(v, lo, hi, pivot_idx, less)
            lo += mid
            continue
        mid, was_p = _partition(v, lo, hi, pivot_idx, less)
        was_balanced = min(mid, length - mid) >= length // 8
        was_partitioned = was_p
        pivot = v[lo + mid]
        if mid < length - mid - 1:
            _recurse(v, lo, lo + mid, less, pred, limit)
            lo = lo + mid + 1
            pred = pivot
        else:
            _recurse(v, lo + mid + 1, hi, less, pivot, limit)
            hi = lo + mid


def quicksort(v: list, less) -> None:
    """In-place unstable sort of `v` with the strict comparator `less`,
    reproducing Rust 1.56.1 `sort_unstable_by` on 64-bit."""
    n = len(v)
    if n == 0:
        return
    limit = n.bit_length()  # usize::BITS - leading_zeros on 64-bit
    _recurse(v, 0, n, less, None, limit)
