"""What the port's kernels assume of the card (H100), and the group rules
that the two shared-structure kernels share."""

from __future__ import annotations

#: Shared memory a Hopper block may use (227 KB of the SM's 256 KB).
SMEM_LIMIT = 232448
#: Shared memory of one SM (228 KB), of which each resident block also
#: takes 1 KB for itself.
SM_SMEM = 233472
BLOCK_RESERVED = 1024
#: SMs on an H100: the group rule wants at least this many blocks.
NUM_SMS = 132
#: The tiled rule wants at least this many blocks: 7/8 of the SMs.
MIN_BLOCKS_TILED = NUM_SMS - NUM_SMS // 8
#: The ring of the tiled product that both shared-structure kernels run
#: (csrc/tiled_product.h): slices in flight, operator rows a slice of the
#: longest row, that row's length in values, and the bytes ahead of the
#: ring that hold the mbarriers.
RING_STAGES, RING_ROWS, SLICE_MAX, RING_MBAR_BYTES = 2, 16, 384, 64


def slice_width(n, m):
    """Row length of a ring buffer of the tiled product: 384 values (one
    pass of the wide product at G >= 8), or all n+m columns, rounded up to
    four, when they are fewer. A wider pass (G < 8) takes fewer rows a
    slice, so the ring does not grow as G falls. Mirrors ``slice_width`` in
    csrc/tiled_product.h."""
    return min(SLICE_MAX, -(-(n + m) // 4) * 4)


def ring_bytes(n, m, itemsize):
    """Bytes of the tiled product's mbarriers and ring of slices."""
    return RING_MBAR_BYTES + RING_STAGES * RING_ROWS * slice_width(n, m) \
        * itemsize


def pick_group(B, groups, smem_of, what):
    """Largest group size G in ``groups`` (descending) whose block,
    ``smem_of(G)`` bytes of shared memory, leaves room for a second block
    on its SM and still gives at least one block per SM; the smallest G
    that fits when the batch of ``B`` lanes cannot fill the card.

    The shared-structure kernels are bound by the latency of their
    operator and shared-memory loads, so a second resident block (more
    warps to switch between) pays more than the operator reuse a larger G
    buys (PERF.md)."""
    fits = [G for G in groups if smem_of(G) <= SMEM_LIMIT]
    if not fits:
        raise ValueError(
            f"one lane of the {what} needs {smem_of(1)} bytes of shared "
            f"memory, more than the {SMEM_LIMIT} a block may use")
    for G in fits:
        two_per_sm = smem_of(G) + BLOCK_RESERVED <= SM_SMEM // 2
        if two_per_sm and -(-B // G) >= NUM_SMS:
            return G
    return fits[-1]


def pick_group_tiled(B, groups, smem_of, what):
    """Largest group size G in ``groups`` (descending) whose block fits and
    that still gives at least 7/8 of the card's SMs a block; the smallest G
    that fits when the batch cannot.

    The tiled product runs one block per SM and hides latency with its copy
    ring and each thread's independent accumulators, not with resident
    warps, so a larger G pays: each operator slice read from L2 serves G
    lanes, and a block's fixed work per slice is shared by more lanes."""
    fits = [G for G in groups if smem_of(G) <= SMEM_LIMIT]
    if not fits:
        raise ValueError(
            f"one lane of the {what} needs {smem_of(1)} bytes of shared "
            f"memory, more than the {SMEM_LIMIT} a block may use")
    for G in fits:
        if -(-B // G) >= MIN_BLOCKS_TILED:
            return G
    return fits[-1]
