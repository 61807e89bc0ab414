"""Video front end: the tap-stacked conv stem + per-frame ResNet-18 trunk.

Port of ``multimodalvc_tpu/nn/resnet.py``.  The public input stays
channels-last ([B, T, H, W, 1]); inside, frames run NCHW, PyTorch's
convolution layout.  The reference's Conv3d(1->64, k=(5,7,7), s=(1,2,2))
keeps the JAX package's 2-D recast: the 5 time taps are stacked as 5 input
channels of a 7x7 stride-2 conv over the (B*T) merged frames.

The mode follows the ``train`` argument, never ``module.train()``.  In
evaluation each BatchNorm runs on its running statistics.  In training it
takes flax's batch statistics (``nn/layers.py: batch_norm_train_``): the
mean and the biased variance over every frame of the batch, padded frames
included, in f32, which normalise and move the running statistics by
momentum 0.9.  ``nn.BatchNorm2d`` in train mode would move them with the
unbiased variance.  The BatchNorms keep their parameters and running
statistics in f32 whatever the module's dtype (flax keeps ``batch_stats``
in f32), and normalise in f32 in both modes: a bf16 running statistic
would round away the momentum step whenever the batch statistic lies
within a few percent of it.  ``relu_type`` is "prelu" (learned per-channel slopes,
the AV-HuBERT recipe) or "relu" (no parameters).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .layers import batch_norm_train_

RELU_TYPES = ("prelu", "relu")


def _conv(cin, cout, k, stride=1, **kw):
    return nn.Conv2d(cin, cout, k, stride=stride, padding=k // 2, bias=False, **kw)


def _bn(c, device=None):
    return nn.BatchNorm2d(c, eps=1e-5, device=device, dtype=torch.float32)


def _relu(c, relu_type, **kw):
    return nn.PReLU(c, init=0.25, **kw) if relu_type == "prelu" else nn.ReLU()


def batch_norm(x: torch.Tensor, norm: nn.BatchNorm2d, train: bool) -> torch.Tensor:
    """``norm`` over NCHW ``x``, in f32: batch statistics in training, else
    running."""
    if not train:
        return norm(x.float()).to(x.dtype)
    return batch_norm_train_(x.float(), norm, channel_dim=1).to(x.dtype)


class BasicBlock(nn.Module):
    def __init__(self, cin: int, planes: int, stride: int = 1, relu_type: str = "prelu",
                 device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.conv1 = _conv(cin, planes, 3, stride, **kw)
        self.bn1 = _bn(planes, device)
        self.relu1 = _relu(planes, relu_type, **kw)
        self.conv2 = _conv(planes, planes, 3, **kw)
        self.bn2 = _bn(planes, device)
        self.relu2 = _relu(planes, relu_type, **kw)
        self.has_downsample = stride != 1 or cin != planes
        if self.has_downsample:
            self.downsample_conv = _conv(cin, planes, 1, stride, **kw)
            self.downsample_bn = _bn(planes, device)

    def forward(self, x, train: bool = False):
        h = self.relu1(batch_norm(self.conv1(x), self.bn1, train))
        h = batch_norm(self.conv2(h), self.bn2, train)
        residual = (batch_norm(self.downsample_conv(x), self.downsample_bn, train)
                    if self.has_downsample else x)
        return self.relu2(h + residual)


class ResNetTrunk(nn.Module):
    """ResNet-18 trunk: layers [2,2,2,2], channels 64/128/256/512."""

    def __init__(self, relu_type: str = "prelu", device=None, dtype=None):
        super().__init__()
        cin = 64
        for li, (planes, stride) in enumerate([(64, 1), (128, 2), (256, 2), (512, 2)]):
            for bi in range(2):
                self.add_module(
                    f"layer{li + 1}_{bi}",
                    BasicBlock(cin, planes, stride if bi == 0 else 1, relu_type, device=device,
                               dtype=dtype),
                )
                cin = planes

    def forward(self, x, train: bool = False):  # [N, 64, H, W]
        for block in self.children():
            x = block(x, train)
        return x.mean(dim=(2, 3))  # adaptive average pool -> [N, 512]


class ResEncoder(nn.Module):
    """[B, T, H, W, 1] video -> [B, T, 512] per-frame embeddings."""

    def __init__(self, relu_type: str = "prelu", device=None, dtype=None):
        super().__init__()
        if relu_type not in RELU_TYPES:
            raise ValueError(f"relu_type {relu_type!r} not in {RELU_TYPES}")
        kw = dict(device=device, dtype=dtype)
        self.frontend_conv = nn.Conv2d(5, 64, 7, stride=2, padding=3, bias=False, **kw)
        self.frontend_bn = _bn(64, device)
        self.frontend_relu = _relu(64, relu_type, **kw)
        self.trunk = ResNetTrunk(relu_type, **kw)

    def forward(self, video: torch.Tensor, train: bool = False) -> torch.Tensor:
        b, t, h0, w0, _ = video.shape
        frames = video[..., 0].to(self.frontend_conv.weight.dtype)  # [B, T, H, W]
        padded = F.pad(frames, (0, 0, 0, 0, 2, 2))  # time taps x[t-2 .. t+2]
        taps = torch.stack([padded[:, j : j + t] for j in range(5)], dim=2)
        x = self.frontend_conv(taps.reshape(b * t, 5, h0, w0))
        x = self.frontend_relu(batch_norm(x, self.frontend_bn, train))
        x = F.max_pool2d(x, 3, stride=2, padding=1)
        return self.trunk(x, train).reshape(b, t, 512)
