"""8-row group gather: kernel K3 (csrc/group_gather.cu) and its plain version.

Counterpart of scripts/bench_gather.py:make_group_gather, the TPU gather
benchmark's Pallas kernel: M groups of 8 consecutive rows of a table
[T, D] f32 (T a multiple of 8) are copied out by group index gidx [M] int32,
out[8 i + r] = table[8 gidx[i] + r].  `group_gather` picks its
implementation from the device of its inputs: the plain PyTorch version on
CPU tensors, kernel K3 on CUDA tensors (a failed build or launch raises).

The plain version is one `index_select` over the table viewed as
[T / 8, 8 D] rows, so it is also the library call K3 is timed against.
"""

import ctypes

import torch


def group_gather_reference(gidx, table):
    """The plain version of K3: [M * 8, D] = the 8-row groups gidx of table."""
    T, D = table.shape
    return torch.index_select(table.view(T // 8, 8 * D), 0, gidx).view(-1, D)


def _check(gidx, table, windows):
    if table.dtype != torch.float32 or gidx.dtype != torch.int32:
        raise TypeError("group_gather takes a float32 table and int32 group indices, got "
                        f"{table.dtype} and {gidx.dtype}")
    if table.dim() != 2 or table.shape[0] % 8 or gidx.dim() != 1:
        raise ValueError("group_gather takes a table [T, D] with T a multiple of 8 and "
                         f"gidx [M], got {tuple(table.shape)} and {tuple(gidx.shape)}")
    if not table.is_contiguous():
        raise ValueError("group_gather takes a contiguous table")
    if gidx.device != table.device:
        raise ValueError("group_gather: operands on different devices")
    if not 1 <= windows <= 32:
        raise ValueError(f"group_gather: windows (groups per block) in 1..32, got {windows}")


def _lib():
    from enerf_torch.ops.cuda_build import load_library
    fn = load_library("group_gather").group_gather_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_longlong] * 2
                       + [ctypes.c_int] * 2 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def launch_kernel(gidx, table, windows=8):
    """Launch K3 on CUDA tensors -> [M * 8, D] f32, `windows` the stages of
    each block's shared-memory ring (groups in flight per block).  An index
    outside [0, T / 8) makes the kernel trap before it copies that index's
    batch (reported at the next sync)."""
    _check(gidx, table, windows)
    if not table.is_cuda:
        raise ValueError("launch_kernel needs CUDA tensors")
    if table.data_ptr() % 16:
        raise ValueError("group_gather: the table must be 16-byte aligned")
    gidx = gidx.contiguous()
    T, D = table.shape
    M = gidx.shape[0]
    out = torch.empty(M * 8, D, dtype=torch.float32, device=table.device)
    # scratch of the slice-order pre-pass: the walk and its slice counters
    order = torch.empty(M, dtype=torch.int32, device=table.device)
    counts = torch.empty(2 * 1024, dtype=torch.int32, device=table.device)
    fn = _lib()
    with torch.cuda.device(table.device):
        stream = torch.cuda.current_stream(table.device).cuda_stream
        err = fn(table.data_ptr(), gidx.data_ptr(), out.data_ptr(), order.data_ptr(),
                 counts.data_ptr(), M, T // 8, D, windows, stream)
    if err != 0:
        raise RuntimeError(f"group_gather kernel launch failed: cudaError {err}")
    group_gather.launches += 1
    return out


def group_gather(gidx, table, windows=8):
    """Gather the 8-row groups `gidx` of `table` -> [M * 8, D] f32: K3 on
    CUDA tensors (the groups taken slice by slice of the table; `windows`
    groups in flight per thread block, TMA bulk copies through a ring of
    that many stages), the plain version on CPU tensors."""
    if table.is_cuda:
        return launch_kernel(gidx, table, windows)
    _check(gidx, table, windows)
    return group_gather_reference(gidx, table)


group_gather.launches = 0  # kernel launches (CUDA path only)
