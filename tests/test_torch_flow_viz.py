"""The port's utils/flow_viz.py against the JAX package's, exactly."""

import numpy as np
import pytest

from perceiverio_pytorch_tpu.utils import flow_viz as jax_viz
from perceiverio_pytorch_tpu_torch.utils import flow_viz as port_viz

_RNG = np.random.default_rng(0)
_FLOW = (_RNG.standard_normal((7, 9, 2)) * 3).astype(np.float32)
_GT = (_RNG.standard_normal((7, 9, 2)) * 3).astype(np.float32)
_VALID = (_RNG.random((7, 9)) > 0.3).astype(np.float32)
_U, _V = (_RNG.uniform(-1.3, 1.3, (5, 6)) for _ in range(2))

CASES = {
    "make_colorwheel": ("make_colorwheel", (), {}),
    "flow_uv_to_colors": ("flow_uv_to_colors", (_U, _V), {}),
    "flow_uv_to_colors_bgr": ("flow_uv_to_colors", (_U, _V), {"convert_to_bgr": True}),
    "flow_to_image": ("flow_to_image", (_FLOW,), {}),
    "flow_to_image_clipped_bgr": ("flow_to_image", (_FLOW,),
                                  {"clip_flow": 2.0, "convert_to_bgr": True}),
    "flow_to_image_zero": ("flow_to_image", (np.zeros((3, 4, 2), np.float32),), {}),
    "plot_flow_legend": ("plot_flow_legend", (), {"size": 41, "show": False}),
    "flow_error_image": ("flow_error_image", (_FLOW, _GT), {}),
    "flow_error_image_linear": ("flow_error_image", (_FLOW, _GT), {"log_scale": False}),
    "get_error_image": ("get_error_image", (_FLOW, _GT), {}),
    "get_error_image_valid": ("get_error_image", (_FLOW, _GT), {"valid": _VALID}),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_flow_viz_matches_jax(case):
    name, args, kwargs = CASES[case]
    got = getattr(port_viz, name)(*args, **kwargs)
    want = getattr(jax_viz, name)(*args, **kwargs)
    if name == "get_error_image":
        assert (got.mode, got.size) == (want.mode, want.size)
        got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    if name == "flow_to_image":
        with pytest.raises(ValueError, match=r"\[H, W, 2\]"):
            port_viz.flow_to_image(np.zeros((3, 4, 3), np.float32))
