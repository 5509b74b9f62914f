"""Per-edge messages of the edge-conditioned conv, without the scatter.

The counterpart of the JAX package's ``ops/pallas_mp.py``, whose Pallas
kernel ``fused_edge_messages`` computes, per edge e,

    m_e = x_src[e] @ (h[e] @ W3 + b3).reshape(C_in, C_out)

and writes only the [E, C_out] messages: the per-edge [C_in, C_out] matrices
never reach device memory.  It is reached through ``mode='pallas'`` in
``ops.message_passing.edge_conditioned_conv``.  On a CUDA tensor
``fused_edge_messages`` launches the hand-written kernel in
``csrc/fused_edge_messages.cu`` (built with the other kernels at first use);
on a CPU tensor it runs ``fused_edge_messages_plain``, the same function and
the reference the kernel is checked against.  Float32 only, and forward only:
the JAX kernel has no VJP, so the wrapper refuses inputs that need a
gradient.
"""

from __future__ import annotations

import torch

from .fused_conv import _check, _load_kernel

_MAX_K = 128
_MAX_C = 64


def fused_edge_messages_plain(h: torch.Tensor, x_src: torch.Tensor,
                              w3: torch.Tensor, b3: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of ``fused_edge_messages`` in float32:
    materializes the per-edge [E, c_in*c_out] matrices."""
    e, c_in = x_src.shape
    c_out = w3.shape[1] // c_in
    w = (h.float() @ w3.float() + b3.float()).reshape(e, c_in, c_out)
    return torch.einsum("ei,eio->eo", x_src.float(), w)


def fused_edge_messages_cuda(h: torch.Tensor, x_src: torch.Tensor,
                             w3: torch.Tensor, b3: torch.Tensor) -> torch.Tensor:
    """Launches the CUDA kernel on the current stream: every operand float32,
    contiguous and on one device; K in 1..128, c_in and c_out in 1..64.
    Checks every operand and raises on what the kernel does not take; raises
    if the launch fails."""
    if h.dim() != 2 or x_src.dim() != 2 or w3.dim() != 2:
        raise ValueError("h, x_src and w3 must be 2-D")
    e, k = h.shape
    c_in = x_src.shape[1]
    c2 = w3.shape[1]
    if not 1 <= k <= _MAX_K:
        raise ValueError(f"K={k} outside the kernel's 1..{_MAX_K}")
    if not 1 <= c_in <= _MAX_C or c2 % c_in:
        raise ValueError(f"c_in={c_in} outside 1..{_MAX_C} or not dividing "
                         f"w3's {c2} columns")
    c_out = c2 // c_in
    if e >= 2**31:
        raise ValueError(f"E={e} edges: the kernel takes fewer than 2^31")
    if not 1 <= c_out <= _MAX_C:
        raise ValueError(f"c_out={c_out} outside the kernel's 1..{_MAX_C}")
    f32 = torch.float32
    _check("h", h, f32, (e, k))
    _check("x_src", x_src, f32, (e, c_in))
    _check("w3", w3, f32, (k, c2))
    _check("b3", b3, f32, (c2,))
    dev = h.device
    for name, t in (("x_src", x_src), ("w3", w3), ("b3", b3)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, h on {dev}")
    out = torch.empty((e, c_out), dtype=f32, device=dev)
    if e == 0:
        return out
    lib = _load_kernel("fused_edge_messages")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.fused_edge_messages_forward(
            h.data_ptr(), x_src.data_ptr(), w3.data_ptr(), b3.data_ptr(),
            out.data_ptr(), e, k, c_in, c_out, stream)
    if err != 0:
        smem = lib.fused_edge_messages_smem_bytes(k, c_in, c_out)
        raise RuntimeError(
            f"fused_edge_messages kernel launch failed: cudaError {err} "
            f"(E={e}, K={k}, c_in={c_in}, c_out={c_out}: {smem} B of shared "
            "memory per block)")
    fused_edge_messages.launches += 1
    return out


def fused_edge_messages(h: torch.Tensor, x_src: torch.Tensor,
                        w3: torch.Tensor, b3: torch.Tensor,
                        block_e: int = 256) -> torch.Tensor:
    """Messages m_e = x_src[e] @ (h[e] @ W3 + b3).reshape(C_in, C_out).

    Args:
      h: [E, K] edge-MLP hidden features (post-activation).
      x_src: [E, C_in] gathered sender features.
      w3: [K, C_in * C_out] final edge-MLP layer weight.
      b3: [C_in * C_out] final edge-MLP bias.
      block_e: the JAX kernel's edges per block; checked, and without
        effect on the result (the CUDA kernel tiles edges its own way).

    Returns [E, C_out] float32.  CUDA operands launch the kernel
    (``fused_edge_messages.launches`` counts the launches); CPU operands run
    ``fused_edge_messages_plain``.  Raises if an input requires a gradient
    while grad mode is on: like the JAX kernel, this one has no backward.
    """
    if isinstance(block_e, bool) or not isinstance(block_e, int) or block_e < 1:
        raise ValueError(f"block_e={block_e!r} must be a positive int")
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (h, x_src, w3, b3)):
        raise RuntimeError(
            "fused_edge_messages (conv mode 'pallas') has no backward, as the "
            "JAX package's Pallas kernel has none: run it under "
            "torch.no_grad(), or train with mode 'edge3d' or 'factored' or "
            "the fused layout")
    if h.device.type == "cpu":
        return fused_edge_messages_plain(h, x_src, w3, b3)
    f32 = torch.float32
    return fused_edge_messages_cuda(h.to(f32).contiguous(),
                                    x_src.to(f32).contiguous(),
                                    w3.to(f32).contiguous(),
                                    b3.to(f32).contiguous())


fused_edge_messages.launches = 0
