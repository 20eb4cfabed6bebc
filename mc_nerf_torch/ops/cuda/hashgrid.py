"""The hash encoding on the card: ``csrc/hashgrid.cu``.

:func:`hash_encode_cuda` is ``models/hashgrid.py::hash_encode_plain`` as a
``torch.autograd.Function`` of two launches: the forward
(``hash_encode_fwd_kernel``: [P, 3] fp32 points and the level gate in,
[P, 2L] bf16 features out, the MLPs' operand type) and the backward
(``hash_encode_bwd_kernel``: the table's gradient by fp32 atomic adds into
a zeroed [E, 2] buffer, the points' gradient for the cameras).  It
replaces no TPU kernel (the JAX package has no hash-grid field); what
bounds it and why it is laid out so: the ``.cu`` file's head.

The atomics add in no fixed order, so the table's gradient differs from
run to run in its last bits: a graph replay and the loop agree to a
tolerance, not bit for bit.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

# the wrapper's launches, forward and backward (a capture counts its own)
launches = {"fwd": 0, "bwd": 0}


def _lib():
    from mc_nerf_torch.ops.cuda import _build

    lib = _build.load("hashgrid")
    geometry = [ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_float,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    lib.mcn_hashgrid_fwd.argtypes = [ctypes.c_void_p] * 4 + geometry
    lib.mcn_hashgrid_fwd.restype = ctypes.c_int
    lib.mcn_hashgrid_bwd.argtypes = [ctypes.c_void_p] * 6 + geometry
    lib.mcn_hashgrid_bwd.restype = ctypes.c_int
    return lib


class _Geometry:
    """The levels as the C interface takes them: ctypes arrays kept alive
    with the call's arguments."""

    def __init__(self, grid, lo: float, hi: float):
        n = grid.levels
        self.res = (ctypes.c_int * n)(*grid.res)
        self.offsets = (ctypes.c_longlong * n)(*grid.offsets)
        self.hashed = (ctypes.c_int * n)(*(int(h) for h in grid.hashed))
        self.args = [grid.levels, grid.table_size.bit_length() - 1, float(lo), 1.0 / (hi - lo),
                     ctypes.cast(self.res, ctypes.c_void_p), ctypes.cast(self.offsets,
                                                                         ctypes.c_void_p),
                     ctypes.cast(self.hashed, ctypes.c_void_p)]


def check_args(x: torch.Tensor, table: torch.Tensor, gate: Optional[torch.Tensor], grid) -> None:
    """Raise ValueError unless the kernels take these inputs: ``x`` a
    contiguous float32 [P, 3], ``table`` a contiguous float32 [E, 2] of the
    grid's E rows on an 8-byte boundary, ``gate`` None or a contiguous
    float32 [L], all on one CUDA device; L a divisor of 32; T a power of
    two."""
    if x.dim() != 2 or x.shape[1] != 3 or x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError("hash_encode_cuda: x must be a contiguous float32 [P, 3]")
    if (tuple(table.shape) != (grid.entries, 2) or table.dtype != torch.float32
            or not table.is_contiguous()):
        raise ValueError(f"hash_encode_cuda: table must be a contiguous float32 "
                         f"[{grid.entries}, 2], not {tuple(table.shape)} {table.dtype}")
    if table.data_ptr() % 8:
        raise ValueError("hash_encode_cuda: the table must start on an 8-byte boundary")
    if 32 % grid.levels:
        raise ValueError(f"hash_encode_cuda: {grid.levels} levels; the kernels take a "
                         "divisor of 32")
    if grid.table_size & (grid.table_size - 1):
        raise ValueError("hash_encode_cuda: T must be a power of two")
    if gate is not None and (tuple(gate.shape) != (grid.levels,) or gate.dtype != torch.float32
                             or not gate.is_contiguous()):
        raise ValueError(f"hash_encode_cuda: gate must be a contiguous float32 [{grid.levels}]")
    if x.device.type != "cuda" or any(t is not None and t.device != x.device
                                      for t in (table, gate)):
        raise ValueError("hash_encode_cuda: the inputs must share one CUDA device")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def encode_fwd(x, table, gate, grid, lo: float, hi: float) -> torch.Tensor:
    """One forward launch: [P, 2L] bf16 features, allocated here."""
    out = torch.empty((x.shape[0], grid.out_dim), dtype=torch.bfloat16, device=x.device)
    geo = _Geometry(grid, lo, hi)
    err = _lib().mcn_hashgrid_fwd(x.data_ptr(), table.data_ptr(),
                                  None if gate is None else gate.data_ptr(), out.data_ptr(),
                                  x.shape[0], *geo.args, _stream(x))
    if err:
        raise RuntimeError(f"hash encode kernel launch failed: CUDA error {err}")
    launches["fwd"] += 1
    return out


def encode_bwd(x, table, gate, grid, lo: float, hi: float, gout: torch.Tensor,
               need_x: bool = True):
    """One backward launch: (the table's gradient [E, 2] fp32, the points'
    [P, 3] fp32 or None), allocated here; ``gout`` [P, 2L] bf16."""
    gout = gout.to(torch.bfloat16).contiguous()
    gtable = torch.zeros_like(table)
    gx = torch.empty_like(x) if need_x else None
    geo = _Geometry(grid, lo, hi)
    err = _lib().mcn_hashgrid_bwd(x.data_ptr(), table.data_ptr(),
                                  None if gate is None else gate.data_ptr(), gout.data_ptr(),
                                  gtable.data_ptr(), None if gx is None else gx.data_ptr(),
                                  x.shape[0], *geo.args, _stream(x))
    if err:
        raise RuntimeError(f"hash encode backward launch failed: CUDA error {err}")
    launches["bwd"] += 1
    return gtable, gx


class _HashEncode(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, table, gate, grid, lo, hi):
        ctx.save_for_backward(x, table, gate)
        ctx.geometry = (grid, lo, hi)
        return encode_fwd(x, table, gate, grid, lo, hi)

    @staticmethod
    def backward(ctx, gout):
        x, table, gate = ctx.saved_tensors
        grid, lo, hi = ctx.geometry
        gtable, gx = encode_bwd(x, table, gate, grid, lo, hi, gout, ctx.needs_input_grad[0])
        return gx, gtable, None, None, None, None


def hash_encode_cuda(x: torch.Tensor, table: torch.Tensor, gate: Optional[torch.Tensor], grid,
                     lo: float, hi: float) -> torch.Tensor:
    """``hash_encode_plain(x, table, gate, grid, lo, hi)`` on the card, in
    bf16 (see the module): inputs as :func:`check_args` says, which raises
    on any other; a refused launch raises.  The gate takes no gradient."""
    x = x.float().contiguous()
    gate = None if gate is None else gate.detach().float().contiguous()
    check_args(x, table, gate, grid)
    return _HashEncode.apply(x, table, gate, grid, lo, hi)
