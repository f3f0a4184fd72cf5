"""Operations and bytes of the port's hand kernels, and the card's peaks.

A kernel launch's bound is the larger of the bytes it must move over the
HBM rate and its operations over the float32 rate outside the tensor cores
(K1 stays IEEE float32): each input byte read once, each output byte
written once. Peaks of one H100 SXM at its 700 W limit (NVIDIA's data
sheet).

K1 (`match_tile_kernel` + `match_merge_kernel`): both directions' two
nearest neighbours of B slots of (N1, D) x (N2, D) descriptors, with the
masking penalties and, with the prefilter, the keypoints: 2 N1 N2 D
operations for the distances and 4 N1 N2 for the keypoint products per
slot; a side without a slot axis is read once for all slots; per row and
per column an int32 index and two float32 distances are written.
K2 (`seg_pieces_kernel` + `seg_merge_kernel`, or one `seg_rows_kernel` on
its one-pass path): the rows in segments and one int32 index each, the
plan's offsets, the (S, K) sums written once; one add per element. On a
sparse plan the kernel writes the filled segments alone (a memset zeroes
the output first, and is not a hand kernel).
K3 (`seg_rows_kernel`): (rows, K) contributions and the S + 1 offsets
read, (S, K) sums written.
"""

HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12

# Device kernel names of K1-K3, as the profiler reports them (templates
# carry their arguments after the name).
HAND_KERNELS = ("match_tile_kernel", "match_merge_kernel", "seg_pieces_kernel",
                "seg_merge_kernel", "seg_rows_kernel")


def is_hand_kernel(name):
    return any(name.startswith(k) or f" {k}" in name or f"::{k}" in name
               for k in HAND_KERNELS)


def bound_s(nbytes, flops):
    """The least time the card could take for the launch."""
    return max(nbytes / HBM_BYTES_PER_S, flops / F32_FLOP_PER_S)


def k1_cost(B, N1, N2, D, shared1, shared2, use_kp):
    """(bytes, flops) of one K1 launch of B slots (shared1 / shared2: that
    side has no slot axis)."""
    b1, b2 = (1 if shared1 else B), (1 if shared2 else B)
    n_in = b1 * N1 * (D + 1) + b2 * N2 * (D + 1)
    if use_kp:
        n_in += 2 * (b1 * N1 + b2 * N2)
    n_out = 3 * B * (N1 + N2)
    flops = B * (2 * N1 * N2 * D + (4 * N1 * N2 if use_kp else 0))
    return 4 * (n_in + n_out), flops


def k2_cost(rows, K, S, written_segments=None):
    """(bytes, flops) of one K2 launch: `rows` rows in segments, K columns,
    S segments (offsets), `written_segments` of them written (S unless the
    plan is sparse)."""
    w = S if written_segments is None else written_segments
    return 4 * (rows * K + rows + S + 1 + w * K), rows * K


def k3_cost(rows, K, S):
    """(bytes, flops) of one K3 launch."""
    return 4 * (rows * K + S + 1 + S * K), rows * K
