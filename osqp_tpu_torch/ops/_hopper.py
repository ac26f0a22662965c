"""What the port's kernels assume of the card (H100), and the group rule
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
