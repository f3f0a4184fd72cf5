"""Sums, small products and elementwise functions whose bits do not depend
on the batch.

On a CUDA device, torch.sum over a row picks its launch shape (threads per
output, values per thread) by the number of rows, and a batched matmul its
cuBLAS kernel by the batch, so a slot's sum in a batch of 32 slots can
differ in its last bits from the same slot's sum alone (found on an H100
by benchmarks/torch_batched_geometry.py). The batched registration steps
must give each slot the single step's bits, so the sums over a slot's rows
(the pose LM's cost and normal equations, the 8-point refit's normal
matrix, the mean triangulation angle) go through `sum_pairwise`, and the
per-slot 3x3 products (rotations, camera centres, the essential matrix's
factors) through `matmul_ordered`: elementwise operations in an order
fixed by the shapes of one slot alone, on both devices. The linear algebra
of one matrix per slot (the two-view step's 8-point eigh and SVDs) runs
`one_by_one`, and a 3x3 determinant is `det3`.

On the CPU, PyTorch evaluates atan2 and pow with SIMD code over whole
vectors and with the C library's scalar code over what is left of a
contiguous run, and the two differ in the last bit: a slot's value then
depended on how many slots came before it. Those go through
`elementwise_fixed`.
"""

import torch
import torch.nn.functional as F


def sum_pairwise(x, dim=-1):
    """Sum of x over `dim` by pairwise halving (zero-padded to a power of
    two): the same bits for a row whatever the other dims hold."""
    x = x.movedim(dim, -1)
    n = x.shape[-1]
    size = 1 << max(n - 1, 0).bit_length()
    if size != n:
        x = F.pad(x, (0, size - n))
    while x.shape[-1] > 1:
        half = x.shape[-1] // 2
        x = x[..., :half] + x[..., half:]
    return x[..., 0]


def matmul_ordered(a, b):
    """a @ b over leading dims, (..., m, k) @ (..., k, n), as elementwise
    products added in the order of k: for small k."""
    out = a[..., :, 0:1] * b[..., 0:1, :]
    for k in range(1, a.shape[-1]):
        out = out + a[..., :, k:k + 1] * b[..., k:k + 1, :]
    return out


def one_by_one(fn, x):
    """fn(x) for a batch of matrices x (..., m, n), called on one matrix at
    a time, its outputs (a tuple of tensors) stacked back to x's leading
    dims. A cuSOLVER routine's result for a matrix can depend on the other
    matrices of its call: on an H100 the f64 eigh of one slot's 8-point
    normal matrix took other bits among 32 slots than alone
    (tools/torch_two_view_bits.py). For the few per-slot matrices of a
    step."""
    lead, flat = x.shape[:-2], x.reshape((-1,) + tuple(x.shape[-2:]))
    if flat.shape[0] == 1:
        return tuple(fn(x))
    parts = zip(*(fn(m[None]) for m in flat)) if flat.shape[0] else zip(*fn(flat))
    return tuple(torch.cat(p).reshape(lead + p[0].shape[1:]) for p in parts)


def det3(m):
    """The determinant of (..., 3, 3) matrices by cofactors along the first
    row, in a fixed order (torch.linalg.det's LU runs batched or per matrix
    by the batch count)."""
    def c(i, j):
        return m[..., i, j]

    return (c(0, 0) * (c(1, 1) * c(2, 2) - c(1, 2) * c(2, 1))
            - c(0, 1) * (c(1, 0) * c(2, 2) - c(1, 2) * c(2, 0))
            + c(0, 2) * (c(1, 0) * c(2, 1) - c(1, 1) * c(2, 0)))


def elementwise_fixed(fn, *args):
    """fn(*args) for an elementwise torch function, with each element's
    bits independent of the tensors' sizes. On the CPU the tensor
    arguments are read through a stride of two, so that every element
    takes the scalar code; on CUDA every element runs the same code and
    fn is called as it is."""
    if not any(torch.is_tensor(a) and a.device.type == "cpu" for a in args):
        return fn(*args)
    return fn(*(torch.stack([a, a], dim=-1)[..., 0] if torch.is_tensor(a) else a
                for a in args))
