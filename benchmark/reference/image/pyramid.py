"""Dual image pyramid (intensity + gradient magnitude) — port of
``sdvo_tpu.image.pyramid.build_pyramid``.

``pyr_down`` is the natural GPU form of OpenCV's pyrDown: a separable
[1,4,6,4,1]/16 blur with BORDER_REFLECT_101 padding evaluated at stride 2
(output ``ceil(n/2)``). The JAX reference writes the same operator as two
matmuls against constant decimation matrices, a TPU layout workaround; the
numbers are the same up to float rounding.
"""

from __future__ import annotations

from typing import List, NamedTuple

import torch
import torch.nn.functional as F

from benchmark.reference.device import constant

_PYRDOWN_TAPS = (1.0 / 16.0, 4.0 / 16.0, 6.0 / 16.0, 4.0 / 16.0, 1.0 / 16.0)


def abs_gradient_saturated_sum(image: torch.Tensor, saturate: float = 255.0) -> torch.Tensor:
    """saturated |central dx| + |central dy|; borders zero (Simd's definition)."""
    interior = torch.abs(image[1:-1, 2:] - image[1:-1, :-2]) + torch.abs(image[2:, 1:-1] - image[:-2, 1:-1])
    out = torch.zeros_like(image)
    out[1:-1, 1:-1] = torch.clamp(interior, 0.0, saturate)
    return out


def pyr_down(image: torch.Tensor) -> torch.Tensor:
    """5-tap Gaussian blur + 2× decimation with REFLECT_101 borders."""
    k = constant(_PYRDOWN_TAPS, image.dtype, image.device)
    x = F.pad(image[None, None], (2, 2, 2, 2), mode="reflect")  # reflect == REFLECT_101
    x = F.conv2d(x, k.view(1, 1, 5, 1), stride=(2, 1))
    x = F.conv2d(x, k.view(1, 1, 1, 5), stride=(1, 2))
    return x[0, 0]


class ImagePyramid(NamedTuple):
    images: tuple  # (H_l, W_l) per level, level 0 finest
    gradients: tuple

    @property
    def num_levels(self) -> int:
        return len(self.images)

    def image_at(self, level: int) -> torch.Tensor:
        return self.images[level]

    def gradient_at(self, level: int) -> torch.Tensor:
        return self.gradients[level]

    @property
    def base_image(self) -> torch.Tensor:
        return self.images[0]

    @property
    def base_gradient(self) -> torch.Tensor:
        return self.gradients[0]


def build_pyramid(image: torch.Tensor, num_levels: int, quantize: bool = False) -> ImagePyramid:
    """Intensity and gradient-magnitude pyramids with ``num_levels`` levels.
    ``quantize=True`` rounds every level below the input to the uint8 grid
    (half to even; the dtype stays), the reference's all-uint8 pyramid."""
    if image.dtype == torch.uint8:
        image = image.to(torch.float32)
    images: List[torch.Tensor] = []
    grads: List[torch.Tensor] = []
    cur_i, cur_g = image, abs_gradient_saturated_sum(image)
    for _ in range(num_levels):
        images.append(cur_i)
        grads.append(cur_g)
        cur_i = pyr_down(cur_i)
        cur_g = pyr_down(cur_g)
        if quantize:
            cur_i = torch.round(cur_i)
            cur_g = torch.round(cur_g)
    return ImagePyramid(tuple(images), tuple(grads))
