"""Optical-flow Perceiver and tiled inference: the port's serving path.

Counterpart of ``perceiverio_pytorch_tpu/models/flow.py``:
  * ``FlowPerceiver``: 3x3 patch features over 2 stacked frames, 2048
    latents x 512 channels, 24 self-attends with 16 heads, a zero-initialised
    decoder projection, flow scale 0.2.  At the published width every one of
    its 26 attention sites takes the flash kernel on a GPU, forward and
    backward.  ``remat`` rematerialises the self-attend stack in the
    backward, as in the JAX package's training configuration.
  * ``compute_grid_indices``: train-size tiles covering an image, every
    origin clamped inside the image (the JAX package's fix).
  * ``FlowInference``: tiles an arbitrary-size frame pair, runs all tiles
    of a request as one batched forward (or as fixed-size waves, in a
    Python loop), and blends them with centre-weighted overlap.

Both take ``device``, "cuda" by default; with no GPU they raise unless the
caller asks for ``device="cpu"``.  Weights are drawn from a
``torch.Generator`` (seed 0 when none is given).
"""

from __future__ import annotations

import itertools
from typing import Sequence

import torch
from torch import nn

from perceiverio_pytorch_tpu_torch.config import DEFAULT, Policy
from perceiverio_pytorch_tpu_torch.core.perceiver import PerceiverIO
from perceiverio_pytorch_tpu_torch.core.position_encoding import PosEncodingType
from perceiverio_pytorch_tpu_torch.core.queries import FlowQuery
from perceiverio_pytorch_tpu_torch.io_processors.postprocessors import FlowPostprocessor
from perceiverio_pytorch_tpu_torch.io_processors.preprocessors import ImagePreprocessor
from perceiverio_pytorch_tpu_torch.io_processors.processor_utils import patches_for_flow
from perceiverio_pytorch_tpu_torch.utils.device import resolve_device  # noqa: F401 (re-exported)
from perceiverio_pytorch_tpu_torch.utils.initializers import default_generator


class FlowPerceiver(nn.Module):
    """Perceiver for optical flow."""

    def __init__(
        self,
        img_size: Sequence[int] = (368, 496),
        flow_scale_factor: float = 20 / 100,
        num_latents: int = 2048,
        num_latent_channels: int = 512,
        num_self_attends_per_block: int = 24,
        num_blocks: int = 1,
        policy: Policy = DEFAULT,
        remat: bool = False,
        *,
        device="cuda",
        generator=None,
    ):
        super().__init__()
        device = resolve_device(device)
        g = default_generator(generator)
        self.img_size = tuple(img_size)
        channels, patch_size = 3, 3
        preprocessor = ImagePreprocessor(
            img_size=self.img_size,
            input_channels=channels * patch_size**2,
            position_encoding_type=PosEncodingType.FOURIER,
            fourier_position_encoding_kwargs=dict(
                num_bands=64, max_resolution=self.img_size,
                sine_only=False, concat_pos=True,
            ),
            n_extra_pos_mlp=0,
            prep_type="patches",
            spatial_downsample=1,
            conv_after_patching=True,
            temporal_downsample=2,
            num_channels=64,
            generator=g,
        )
        query = FlowQuery(
            preprocessed_input_channels=preprocessor.n_output_channels(),
            output_img_size=self.img_size,
            output_num_channels=2,
        )
        postprocessor = FlowPostprocessor(
            img_size=self.img_size, flow_scale_factor=flow_scale_factor)
        self.perceiver = PerceiverIO(
            final_project_out_channels=2,
            num_blocks=num_blocks,
            num_self_attends_per_block=num_self_attends_per_block,
            num_latents=num_latents,
            num_latent_channels=num_latent_channels,
            perceiver_encoder_kwargs=dict(num_self_attend_heads=16),
            perceiver_decoder_kwargs=dict(output_w_init="zeros"),
            output_queries=query,
            input_preprocessors=preprocessor,
            output_postprocessors=postprocessor,
            policy=policy,
            remat=remat,
            generator=g,
        )
        self.to(device)

    def forward(self, image1: torch.Tensor, image2: torch.Tensor) -> torch.Tensor:
        """Flow for a train-size frame pair.

        Args:
          image1, image2: [B, 3, H, W] with (H, W) == img_size, in [-1, 1].
        Returns:
          [B, 2, H, W] flow field.
        """
        if tuple(image1.shape[-2:]) != self.img_size:
            raise ValueError(
                f"Images must have size {self.img_size}; use FlowInference for"
                f" arbitrary sizes (got {tuple(image1.shape)})."
            )
        inputs = torch.stack([image1, image2], dim=1)  # [B, 2, 3, H, W]
        inputs = torch.movedim(inputs, -3, -1)  # [B, 2, H, W, 3]
        patches = patches_for_flow(inputs)  # [B, 2, H, W, 27]
        patches = torch.movedim(patches, -1, -3)  # [B, 2, 27, H, W]
        return self.perceiver(patches)


def compute_grid_indices(image_shape: Sequence[int], patch_size: Sequence[int],
                         min_overlap: int = 20):
    """Top-left coordinates of train-size tiles covering ``image_shape``."""
    ph, pw = patch_size
    if min_overlap >= ph or min_overlap >= pw:
        raise ValueError(
            f"Overlap should be less than size of patch (got {min_overlap}"
            f"for patch size {(ph, pw)})."
        )
    ys = range(0, image_shape[0], ph - min_overlap)
    xs = range(0, image_shape[1], pw - min_overlap)
    # Clamp every origin inside the image, then dedupe in order.
    ys = list(dict.fromkeys(min(y, image_shape[0] - ph) for y in ys))
    xs = list(dict.fromkeys(min(x, image_shape[1] - pw) for x in xs))
    return list(itertools.product(ys, xs))


class FlowInference:
    """Arbitrary-size flow inference: tiling, one batched forward, blending.

    ``wave_size``: when > 0 and a request has more tiles than that, the tiles
    run as waves of at most ``wave_size`` in a Python loop, which bounds the
    activation memory to one wave; 0 runs all tiles in one forward.

    ``mesh`` (``parallel.make_mesh``): the tiles are data parallel.  Every
    rank makes the request's stacked tiles, padded cyclically to a multiple
    of the data axis's size D; each rank runs its contiguous share of each
    wave (``parallel.make_data_parallel_apply``: the weights replicated) and
    the flows are all-gathered, so every rank returns the whole result.
    ``wave_size`` is rounded up to a multiple of D, as in the JAX package.
    The model runs on the mesh's device (``device`` is ignored).
    """

    def __init__(self, model: FlowPerceiver, min_overlap: int = 20,
                 wave_size: int = 0, *, device="cuda", mesh=None):
        self.mesh = mesh
        self._dp_size = 1
        if mesh is not None:
            from perceiverio_pytorch_tpu_torch.parallel import (
                make_data_parallel_apply,
                mesh_device,
            )
            from perceiverio_pytorch_tpu_torch.parallel.mesh import DATA_AXIS, axis

            self.device = mesh_device(mesh)
            self._dp_size = axis(mesh, DATA_AXIS).size
            self._apply, self._place = make_data_parallel_apply(model, mesh)
        else:
            self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.min_overlap = min_overlap
        self.wave_size = wave_size or 0
        if self.wave_size and self._dp_size > 1:
            self.wave_size = -(-self.wave_size // self._dp_size) * self._dp_size
        h, w = model.img_size
        wy, wx = torch.meshgrid(torch.arange(h), torch.arange(w), indexing="ij")
        wx = torch.minimum(wx + 1, w - wx)
        wy = torch.minimum(wy + 1, h - wy)
        weights = torch.minimum(wx, wy)[None, None].float()
        self._weights = (weights / weights.max()).to(self.device)

    @torch.inference_mode()
    def __call__(self, image1, image2, test_mode: bool = True) -> torch.Tensor:
        """image1/image2: [B, 3, H, W] in [-1, 1]; returns [B, 2, H, W] fp32."""
        image1 = torch.as_tensor(image1).to(self.device, torch.float32)
        image2 = torch.as_tensor(image2).to(self.device, torch.float32)
        h, w = self.model.img_size
        height, width = image1.shape[-2:]
        if height < h or width < w:
            raise ValueError(
                f"Image size {(height, width)} must be at least {(h, w)};"
                " pad or resize to the minimum dimension."
            )
        if not test_mode:
            if (height, width) != (h, w):
                raise ValueError(
                    "In training mode images must have size equal to specified"
                    f" img_size {(h, w)}"
                )
            return self.model(image1, image2)

        grid = compute_grid_indices((height, width), (h, w), self.min_overlap)
        batch = image1.shape[0]
        tiles1 = torch.cat([image1[..., y:y + h, x:x + w] for y, x in grid])
        tiles2 = torch.cat([image2[..., y:y + h, x:x + w] for y, x in grid])
        n_stacked = tiles1.shape[0]
        forward = self.model
        if self.mesh is not None:
            pad = -n_stacked % self._dp_size
            if pad:  # cyclic repeats, dropped after the gather
                idx = torch.arange(pad, device=tiles1.device) % n_stacked
                tiles1 = torch.cat([tiles1, tiles1[idx]])
                tiles2 = torch.cat([tiles2, tiles2[idx]])
            weights = self.model.state_dict()

            def forward(t1, t2):
                return self._apply(*self._place(weights, t1, t2))

        step = self.wave_size or tiles1.shape[0]
        flow_tiles = torch.cat([
            forward(tiles1[i:i + step], tiles2[i:i + step])
            for i in range(0, tiles1.shape[0], step)
        ])[:n_stacked]

        flows = torch.zeros((batch, 2, height, width), device=self.device)
        flow_count = torch.zeros((1, 1, height, width), device=self.device)
        for i, (y, x) in enumerate(grid):
            piece = flow_tiles[i * batch:(i + 1) * batch]
            flows[..., y:y + h, x:x + w] += piece * self._weights
            flow_count[..., y:y + h, x:x + w] += self._weights
        return flows / flow_count
