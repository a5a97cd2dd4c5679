"""What the benchmark makes from `--seed` and hands to both the program and
the reference: the image, the observation's noise field and the chains'
noise draws.  Nothing here imports the program."""
from __future__ import annotations

import os
import zlib

import numpy as np
import torch

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")


def derive(seed: int, *tags) -> int:
    """A 63-bit seed for one use of `seed`, named by tags (strings or ints)."""
    words = [int(seed) % 2 ** 64] + [t if isinstance(t, int) else zlib.crc32(t.encode())
                                      for t in tags]
    a, b = np.random.SeedSequence(words).generate_state(2, np.uint32)
    return (int(a) << 31) ^ int(b)


def image(name: str) -> np.ndarray:
    """A grayscale test image as float64 in [0, 255] (the demos' double(imread))."""
    with np.load(os.path.join(DATA, f"{name}.npz")) as f:
        return f["image"].astype(np.float64)


def normal_field(seed: int, shape, device, dtype=torch.float32) -> torch.Tensor:
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return torch.randn(tuple(shape), generator=gen, dtype=dtype, device=device)


class Draws:
    """Standard normals from one generator on `device`, a call at a time;
    the same seed gives the same sequence.  `hook(n)`, if set, is called
    before the n-th draw (from 0)."""

    def __init__(self, seed: int, device, dtype=torch.float32, hook=None):
        self.gen = torch.Generator(device=device)
        self.gen.manual_seed(seed)
        self.device, self.dtype, self.hook = device, dtype, hook
        self.count = 0

    def __call__(self, shape):
        if self.hook is not None:
            self.hook(self.count)
        self.count += 1
        return torch.randn(tuple(shape), generator=self.gen, dtype=self.dtype,
                           device=self.device)
