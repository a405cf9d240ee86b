"""The device rule of the port: ``None`` means CUDA, and nothing carries on
on the CPU by itself."""

from __future__ import annotations

import torch


def resolve_device(device: torch.device | str | None = None) -> torch.device:
    """``None`` -> ``cuda`` (raises without a CUDA device); anything else is
    taken as given. Callers that want the CPU say ``device="cpu"``."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "svi_mapper_tpu_torch runs on a CUDA device by default and "
                "none is available; pass device='cpu' to run on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA device requested but none is available")
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
    return device


def require_fp32_matmul(t: torch.Tensor) -> None:
    """The solvers' matrix products must run in full float32 on the card
    (their L-long contractions stall LM at TF32's three digits). PyTorch's
    default is full float32; a caller that switched TF32 on is told so,
    nothing is flipped here."""
    if t.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError(
            "torch.backends.cuda.matmul.allow_tf32 is True: the map "
            "optimisation needs float32 matrix products; set it to False")


def fetch_numpy(tensors) -> tuple:
    """Numpy copies of several tensors of one device through ONE
    device->host copy (float64 holds every float32, int32, uint8 and bool
    value exactly)."""
    tensors = list(tensors)
    flat = torch.cat([t.reshape(-1).to(torch.float64) for t in tensors]).cpu()
    out, at = [], 0
    for t in tensors:
        part = flat[at: at + t.numel()].reshape(t.shape).to(t.dtype)
        out.append(part.numpy())
        at += t.numel()
    return tuple(out)


def add_device_arguments(ap) -> None:
    """The command-line tools' device flags: ``--device`` (default cuda)
    and ``--cpu``, the same as ``--device cpu``."""
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default: cuda)")
    ap.add_argument("--cpu", action="store_true", help="same as --device cpu")


def device_argument(args) -> torch.device:
    """The device the tools' flags name, resolved by :func:`resolve_device`
    (``cuda`` without a CUDA device raises)."""
    return resolve_device("cpu" if args.cpu else args.device)
