"""Shared helpers of the ``test_torch_*`` parity tests: conversion between
the JAX package's pytrees and the port's dataclasses, through numpy only."""

import dataclasses

import numpy as np
import torch

from svi_mapper_tpu_torch import convert

CPU = "cpu"

# the suite runs several worker processes side by side; PyTorch's default of
# one intra-op thread per core in each of them oversubscribes the machine
torch.set_num_threads(2)


def words(a) -> torch.Tensor:
    """JAX/numpy uint32 packed words -> the port's int32 tensor (same bits)."""
    return convert.words_from_numpy(np.asarray(a), CPU)


def unwords(t) -> np.ndarray:
    """The port's int32 words -> uint32 numpy (same bits)."""
    return convert.words_to_numpy(t)


def t32(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def tint(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.int32))


def tbool(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=bool))


def camera_dict(jcam) -> dict:
    def one(c):
        return {"P": np.asarray(c.P), "K": np.asarray(c.K),
                "dist": np.asarray(c.dist), "R_rect": np.asarray(c.R_rect),
                "width": c.width, "height": c.height}
    return {"left": one(jcam.left), "right": one(jcam.right)}


def torch_camera(jcam):
    return convert.camera_from_numpy(camera_dict(jcam), device=CPU)


def table_dict(jtable) -> dict:
    return {f.name: np.asarray(getattr(jtable, f.name))
            for f in dataclasses.fields(jtable)}


def torch_table(jtable):
    return convert.table_from_numpy(table_dict(jtable), device=CPU)


def state_dict(jstate) -> dict:
    d = {k: np.asarray(getattr(jstate, k))
         for k in ("T_wc", "T_wc_prev", "T_last_keyframe", "next_uid",
                   "frame_idx", "instability")}
    d["table"] = table_dict(jstate.table)
    return d


def torch_state(jstate):
    return convert.state_from_numpy(state_dict(jstate), device=CPU)


def assert_tables_equal(jtable, ttable, float_atol=1e-6, skip=()):
    """Integer/bool/descriptor fields exactly, float fields to ``float_atol``."""
    got = convert.table_to_numpy(ttable)
    for f in dataclasses.fields(jtable):
        if f.name in skip:
            continue
        want = np.asarray(getattr(jtable, f.name))
        have = got[f.name]
        assert want.shape == have.shape, f.name
        if np.issubdtype(want.dtype, np.floating):
            np.testing.assert_allclose(have, want, atol=float_atol, rtol=0,
                                       err_msg=f.name)
        else:
            np.testing.assert_array_equal(have, want, err_msg=f.name)
