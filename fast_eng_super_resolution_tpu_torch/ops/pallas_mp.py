"""Per-edge messages of the edge-conditioned conv, without the scatter.

The counterpart of the JAX package's ``ops/pallas_mp.py``, whose Pallas
kernel ``fused_edge_messages`` computes, per edge e,

    m_e = x_src[e] @ (h[e] @ W3 + b3).reshape(C_in, C_out)

and writes only the [E, C_out] messages: the per-edge [C_in, C_out] matrices
never reach device memory.  It is reached through ``mode='pallas'`` in
``ops.message_passing.edge_conditioned_conv``.  On a CUDA tensor
``fused_edge_messages`` launches the hand-written kernel in
``csrc/fused_edge_messages_wgmma.cu`` (built with the other kernels at first
use): float32 in and out on the tensor cores, each float32 operand split
exactly into three bf16 parts (``split3``), w3 and b3 laid out once per call
as the kernel's shared-memory stages by its first launch (``stage_image`` is
that launch's plain version), in the float32 B1's column chunks of c_out
(``fused_conv.f32_chunks``), past a c_in of 128 in stages of 32 deep
(``fused_conv.f32_depth``).  One launch takes K, c_in and c_out up to 256;
past it the wrapper runs pieces of at most 256 of each on the same
instances (``fused_conv.width_pieces``): the messages are linear in h, x and
[w3; b3], so pieces of K (b3 in the first only) and of c_in add up and
pieces of c_out are columns of their own.  On a CPU tensor it runs
``fused_edge_messages_plain``, the same function and the reference the
kernel is checked against.  Float32 only, and forward only: the JAX
kernel has no VJP, so the wrapper refuses inputs that need a gradient.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from .fused_conv import (_MAX_WIDTH, _check, _load_kernel, f32_chunks,
                         f32_depth, forward_pieces, piece_count, piece_width,
                         weight_pieces)


def design() -> str:
    """The design a B5 launch runs: 'wgmma', the tensor cores' float32-exact
    products of three-part bf16 splits (csrc/fused_edge_messages_wgmma.cu)."""
    return "wgmma"


def split3(v: torch.Tensor) -> tuple:
    """Three bf16 parts of float32 ``v`` with v1 + v2 + v3 == v exactly:
    v1 = bf16(v), v2 = bf16(v - v1), v3 = bf16(v - v1 - v2), each remainder
    exact in float32 and 8 + 8 + 8 significant bits covering float32's 24.
    Exact for 2^-110 <= |v| <= 3.38e38 and for 0 (bf16 has float32's
    exponent range; in the subnormal range the lowest part loses bits)."""
    v1 = v.to(torch.bfloat16)
    r = v - v1.float()
    v2 = r.to(torch.bfloat16)
    return v1, v2, (r - v2.float()).to(torch.bfloat16)


def image_shape(k: int, c_in: int, c_out: int) -> tuple:
    """Shape of the stage image at K = ``k``: [chunks (K+1) slices, 3, n //
    8, sd // 8, 8, 8] bf16, (chunks, n) = ``f32_chunks(c_out, c_in)`` and
    (dp, sd) = ``f32_depth(c_in)``, slices = dp / sd: one stage of dp = c_in
    rounded up to 16 up to 128, past it dp / 32 stages of 32
    (``fused_conv.image_numel(k, c_out, c_in)`` elements)."""
    chunks, n = f32_chunks(c_out, c_in)
    dp, sd = f32_depth(c_in)
    return (chunks * (k + 1) * (dp // sd), 3, n // 8, sd // 8, 8, 8)


def stage_image(w3: torch.Tensor, b3: torch.Tensor, c_in: int) -> torch.Tensor:
    """The kernel's shared-memory stages of W~ = [w3; b3] as [K+1, c_in,
    c_out]: stage (c (K+1) + k) slices + l holds column chunk c of W~_k
    (``f32_chunks``: n columns of c_out from c n on; one chunk of all of
    them up to 64) at depths l sd .. l sd + sd - 1 (``f32_depth``: c_in
    padded to dp; one slice of sd = dp up to 128, past it slices of 32) as
    three bf16 parts (``split3``), each the K-major B operand of a wgmma,
    [n rows (o), sd deep (i)], zero padded, in 8 x 8 core matrices: element
    (o, i) at (o // 8) * 8 sd + (i // 8) * 64 + (o % 8) * 8 + i % 8
    (csrc/wgmma_tile.cuh, kmajor).  The float32 B1's image of the same w3
    and b3 (csrc/f32_wgmma.cuh stage_image, by output).  Returns the bf16
    tensor of ``image_shape`` (contiguous).  The plain version of the
    kernel's first launch, which writes the same bits."""
    k1 = w3.shape[0] + 1
    c_out = w3.shape[1] // c_in
    chunks, n = f32_chunks(c_out, c_in)
    dp, sd = f32_depth(c_in)
    w = torch.cat([w3, b3[None]]).reshape(k1, c_in, c_out)
    parts = torch.stack(split3(w), 1).transpose(2, 3)  # [K+1, 3, o, i]
    parts = F.pad(parts, (0, dp - c_in, 0, chunks * n - c_out))
    parts = parts.reshape(k1, 3, chunks, n // 8, 8, dp // sd, sd // 8, 8)
    # -> [chunk, k, slice, part, o // 8, i // 8, o % 8, i % 8]
    return parts.permute(2, 0, 5, 1, 3, 6, 4, 7).reshape(
        image_shape(k1 - 1, c_in, c_out)).contiguous()


def smem_bytes(k: int, c_in: int, c_out: int) -> int:
    """Bytes of shared memory one block of the kernel takes
    (csrc/fused_edge_messages_wgmma.cu Layout): the ring of four stages of
    three [n, sd] bf16 operands after 128 bytes of barriers, past a c_in of
    128 X's parts [3, 64, dp] bf16, then the h tiles [64, (K+1) | 1]
    float32: two consumer warpgroups up to a c_in of 128, else one; two
    tiles each up to a K of 128, else one.  Past 256 the widest piece's
    (``fused_conv.piece_width``), the instance a piece runs."""
    k, c_in, c_out = (piece_width(v) for v in (k, c_in, c_out))
    _, n = f32_chunks(c_out, c_in)
    dp, sd = f32_depth(c_in)
    deep = c_in > 128
    consumers, hbufs = (1 if deep else 2), (2 if k <= 128 else 1)
    return (128 + 4 * 3 * 2 * n * sd + (3 * 2 * 64 * dp if deep else 0)
            + 4 * hbufs * consumers * 64 * ((k + 1) | 1))


def piece_images(image, w3: torch.Tensor, b3: torch.Tensor, c_in: int,
                 most: int = _MAX_WIDTH) -> torch.Tensor:
    """``image`` (``stage_image`` or ``stage_image_cuda``) of w3 and b3: up
    to ``most`` its image; past it each piece's (``fused_conv.weight_pieces``
    in the order the messages run them) flattened, one after the other."""
    c_out = w3.shape[1] // c_in
    if piece_count(w3.shape[0], c_in, c_out, most) == 1:
        return image(w3, b3, c_in)
    return torch.cat([image(wp, bp, ip[1] - ip[0]).reshape(-1)
                      for _, ip, _, wp, bp in weight_pieces(w3, b3, c_in,
                                                            c_out, most)])


def _stage_image_launch(w3: torch.Tensor, b3: torch.Tensor,
                        c_in: int) -> torch.Tensor:
    """The kernel's first launch alone at K, c_in and c_out up to 256."""
    k, c2 = w3.shape
    c_out = c2 // c_in
    if not (1 <= k <= _MAX_WIDTH and 1 <= c_in <= _MAX_WIDTH
            and 1 <= c_out <= _MAX_WIDTH and c2 == c_in * c_out):
        raise ValueError(f"w3 {tuple(w3.shape)} at c_in={c_in}: outside the "
                         f"kernel's K 1..{_MAX_WIDTH}, widths 1..{_MAX_WIDTH}")
    _check("w3", w3, torch.float32, (k, c2))
    _check("b3", b3, torch.float32, (c2,))
    image = torch.empty(image_shape(k, c_in, c_out), dtype=torch.bfloat16,
                        device=w3.device)
    fn = _load_kernel("fused_edge_messages_wgmma").fused_edge_messages_wgmma_stage_image
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    with torch.cuda.device(w3.device):
        err = fn(w3.data_ptr(), b3.data_ptr(), image.data_ptr(), k, c_in,
                 c_out, torch.cuda.current_stream(w3.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"stage image launch failed: cudaError {err}")
    return image


def stage_image_cuda(w3: torch.Tensor, b3: torch.Tensor,
                     c_in: int) -> torch.Tensor:
    """The kernel's first launch alone, on float32 CUDA tensors w3 [K,
    c_in*c_out] and b3: the stage image, the same bits as ``stage_image``;
    past 256 each piece's, as ``piece_images`` lays them out."""
    if w3.dim() != 2 or c_in < 1 or w3.shape[1] % c_in or not w3.shape[1]:
        raise ValueError(f"w3 {tuple(w3.shape)} at c_in={c_in}: not [K, "
                         "c_in c_out]")
    _check("w3", w3, torch.float32, tuple(w3.shape))
    _check("b3", b3, torch.float32, (w3.shape[1],))
    return piece_images(_stage_image_launch, w3, b3, c_in)


def fused_edge_messages_plain(h: torch.Tensor, x_src: torch.Tensor,
                              w3: torch.Tensor, b3: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of ``fused_edge_messages`` in float32:
    materializes the per-edge [E, c_in*c_out] matrices."""
    e, c_in = x_src.shape
    c_out = w3.shape[1] // c_in
    w = (h.float() @ w3.float() + b3.float()).reshape(e, c_in, c_out)
    return torch.einsum("ei,eio->eo", x_src.float(), w)


def _messages_operands(h: torch.Tensor, x_src: torch.Tensor,
                       w3: torch.Tensor, b3: torch.Tensor,
                       most: int | None = None) -> tuple:
    """Checks B5's operands (K, c_in and c_out up to ``most``, if given)
    and raises on what the kernel does not take; returns (E, K, c_in,
    c_out)."""
    if h.dim() != 2 or x_src.dim() != 2 or w3.dim() != 2:
        raise ValueError("h, x_src and w3 must be 2-D")
    e, k = h.shape
    c_in = x_src.shape[1]
    c2 = w3.shape[1]
    top = most or "any"

    def out_of(v: int) -> bool:
        return v < 1 or (most is not None and v > most)

    if out_of(k):
        raise ValueError(f"K={k} outside the kernel's 1..{top}")
    if out_of(c_in) or c2 % c_in:
        raise ValueError(f"c_in={c_in} outside 1..{top} or not dividing "
                         f"w3's {c2} columns")
    c_out = c2 // c_in
    if e >= 2**31:
        raise ValueError(f"E={e} edges: the kernel takes fewer than 2^31")
    if out_of(c_out):
        raise ValueError(f"c_out={c_out} outside the kernel's 1..{top}")
    f32 = torch.float32
    _check("h", h, f32, (e, k))
    _check("x_src", x_src, f32, (e, c_in))
    _check("w3", w3, f32, (k, c2))
    _check("b3", b3, f32, (c2,))
    for name, t in (("x_src", x_src), ("w3", w3), ("b3", b3)):
        if t.device != h.device:
            raise ValueError(f"{name} is on {t.device}, h on {h.device}")
    return e, k, c_in, c_out


def _messages_launch(h: torch.Tensor, x_src: torch.Tensor, w3: torch.Tensor,
                     b3: torch.Tensor) -> torch.Tensor:
    """One call of the kernel (the stage image, then the messages) at K,
    c_in and c_out up to 256; see ``fused_edge_messages_cuda``."""
    e, k, c_in, c_out = _messages_operands(h, x_src, w3, b3, _MAX_WIDTH)
    f32, dev = torch.float32, h.device
    out = torch.empty((e, c_out), dtype=f32, device=dev)
    if e == 0:
        return out
    lib = _load_kernel("fused_edge_messages_wgmma")
    image = torch.empty(image_shape(k, c_in, c_out), dtype=torch.bfloat16,
                        device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.fused_edge_messages_wgmma_forward(
            h.data_ptr(), x_src.data_ptr(), w3.data_ptr(), b3.data_ptr(),
            image.data_ptr(), out.data_ptr(), e, k, c_in, c_out, stream)
    if err != 0:
        smem = lib.fused_edge_messages_wgmma_smem_bytes(k, c_in, c_out)
        raise RuntimeError(
            f"fused_edge_messages kernel launch failed: cudaError {err} "
            f"(E={e}, K={k}, c_in={c_in}, c_out={c_out}: {smem} B of shared "
            "memory per block)")
    fused_edge_messages.launches += 1
    return out


def fused_edge_messages_pieces(launch, h: torch.Tensor, x_src: torch.Tensor,
                               w3: torch.Tensor, b3: torch.Tensor,
                               most: int = _MAX_WIDTH) -> torch.Tensor:
    """B5 as ``launch`` (one call of the kernel, or the plain version) on
    pieces of at most ``most`` of K, c_in and c_out
    (``fused_conv.forward_pieces``)."""
    c_in = x_src.shape[1]
    return forward_pieces(
        lambda hp, xp, wp, bp, ci, co: launch(hp, xp, wp, bp),
        h, x_src, w3, b3, c_in, w3.shape[1] // c_in, most)


def fused_edge_messages_cuda(h: torch.Tensor, x_src: torch.Tensor,
                             w3: torch.Tensor, b3: torch.Tensor) -> torch.Tensor:
    """Launches the CUDA kernels on the current stream (the stage image of
    w3 and b3 into scratch, then the messages): every operand float32,
    contiguous and on one device; any K, c_in and c_out: up to 256 one
    call, past it one per piece (``fused_edge_messages_pieces``, each with
    its own stage image; ``fused_edge_messages.launches`` counts each).
    Checks every operand and raises on what the kernel does not take;
    raises if a launch fails."""
    c_in = x_src.shape[-1]
    if c_in < 1 or max(h.shape[-1], c_in, w3.shape[-1] // c_in) <= _MAX_WIDTH:
        # one launch (or what its checks refuse), its own checks only
        return _messages_launch(h, x_src, w3, b3)
    _messages_operands(h, x_src, w3, b3)
    return fused_edge_messages_pieces(_messages_launch, h, x_src, w3, b3)


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
