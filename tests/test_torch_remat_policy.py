"""``Policy.remat_policy`` in the port against the JAX package's, on the
tiny flow model.

Every name the port takes (``config.REMAT_POLICIES``) with ``remat=True``:
the loss and each parameter's gradient against ``jax.grad`` of the JAX
model under the same ``remat_policy`` (rtol 2e-4, atol 2e-5; the port's
self-attends through K1's ``torch.library`` op, which runs the plain version
on the CPU, inside the checkpointed region).  Under ``dots_saveable`` a
``TorchDispatchMode`` counts the backward's ops: it runs as many
``mm``/``addmm``/``bmm``/``baddbmm`` as a backward without remat (the
products are kept, none reruns), and reruns K1's op at each self-attend, as
JAX recomputes a ``pallas_call``.  Names JAX has and the port does not take
raise.
"""

import collections

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import jax
import jax.numpy as jnp

from perceiverio_pytorch_tpu import config as jax_config
from perceiverio_pytorch_tpu.models import flow as jax_flow
from perceiverio_pytorch_tpu.training import flow_endpoint_error as jax_epe
from perceiverio_pytorch_tpu_torch import config as port_config
from perceiverio_pytorch_tpu_torch.models import flow as port_flow
from perceiverio_pytorch_tpu_torch.ops import flash_attention as fa
from perceiverio_pytorch_tpu_torch.training import flow_endpoint_error
from perceiverio_pytorch_tpu_torch.utils.weights import state_dict_from_flax

torch.set_num_threads(1)
TOL = dict(rtol=2e-4, atol=2e-5)
SMALL = dict(img_size=(16, 24), num_latents=8, num_latent_channels=32,
             num_self_attends_per_block=2)
PRODUCTS = {"mm", "addmm", "bmm", "baddbmm"}
FLASH_OP = fa.OP_NAME.replace("::", ".")


class OpCounts(TorchDispatchMode):
    """Counts every aten or custom op by its packet name (``aten.mm``)."""

    def __init__(self):
        super().__init__()
        self.counts = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.counts[str(func.overloadpacket)] += 1
        return func(*args, **(kwargs or {}))

    def products(self):
        return sum(n for name, n in self.counts.items() if name.split(".")[-1] in PRODUCTS)


def _data(seed):
    rng = np.random.default_rng(seed)
    shape = (1, 3) + SMALL["img_size"]
    return (rng.uniform(-1, 1, shape).astype(np.float32),
            rng.uniform(-1, 1, shape).astype(np.float32),
            rng.uniform(-2, 2, (1, 2) + SMALL["img_size"]).astype(np.float32))


def _port_model(remat, remat_policy, variables=None):
    pm = port_flow.FlowPerceiver(
        **SMALL, remat=remat, device="cpu", generator=torch.Generator().manual_seed(1),
        policy=port_config.Policy(compute_dtype=torch.float32, attn_impl="flash",
                                  remat_policy=remat_policy))
    if variables is not None:
        pm.load_state_dict(state_dict_from_flax(variables), strict=True)
    return pm.train()


_JAX = {}  # jax.checkpoint_policies function -> (variables, loss, gradients)


def _jax_gradients(name, img1, img2, gt):
    """The JAX model's loss and gradients under ``name``; an alias
    (``checkpoint_dots``) is the same function as its name, computed once."""
    key = getattr(jax.checkpoint_policies, name)
    if key not in _JAX:
        jax_pol = jax_config.Policy(compute_dtype=jnp.float32, attn_impl="xla",
                                    remat_policy=name)
        jm = jax_flow.FlowPerceiver(**SMALL, policy=jax_pol, remat=True)
        variables = jax.jit(jm.init)(jax.random.PRNGKey(3), img1, img2)
        params = jax.tree_util.tree_map(np.asarray, variables["params"])
        final = params["perceiver"]["decoder"]["final_layer"]  # zero-initialised by design
        final["kernel"] = np.random.default_rng(4).standard_normal(
            final["kernel"].shape).astype(np.float32) * 0.1
        variables = {**variables, "params": params}

        def loss(p):
            return jax_epe(jm.apply({**variables, "params": p}, img1, img2), gt)

        want_loss, grads = jax.jit(jax.value_and_grad(loss))(variables["params"])
        _JAX[key] = variables, want_loss, state_dict_from_flax({"params": grads})
    return _JAX[key]


@pytest.mark.parametrize("name", sorted(port_config.REMAT_POLICIES))
def test_flow_gradients_under_remat_policy_match_jax(name):
    img1, img2, gt = _data(0)
    variables, want_loss, want = _jax_gradients(name, img1, img2, gt)
    pm = _port_model(True, name, variables)
    got_loss = flow_endpoint_error(pm(torch.from_numpy(img1), torch.from_numpy(img2)),
                                   torch.from_numpy(gt))
    got_loss.backward()
    np.testing.assert_allclose(got_loss.item(), float(want_loss), **TOL)
    for pname, p in pm.named_parameters():
        grad = torch.zeros_like(p) if p.grad is None else p.grad
        np.testing.assert_allclose(grad.numpy(), want[pname].numpy(), err_msg=pname, **TOL)


def _backward_counts(remat, remat_policy):
    pm = _port_model(remat, remat_policy)
    img1, img2, gt = (torch.from_numpy(a) for a in _data(5))
    loss = flow_endpoint_error(pm(img1, img2), gt)
    with OpCounts() as counts:
        loss.backward()
    return counts, {n: p.grad.clone() for n, p in pm.named_parameters() if p.grad is not None}


def test_dots_saveable_reruns_no_product_in_the_backward():
    """The backward under dots_saveable runs the products a backward without
    remat runs, and K1 once more at each of the self-attends in the region
    (2 here, the flow model's 24 at full width); full remat reruns the
    products too.  The gradients are the same bit for bit, as the plain
    (no-remat) ones."""
    plain, g_plain = _backward_counts(False, None)
    dots, g_dots = _backward_counts(True, "dots_saveable")
    full, g_full = _backward_counts(True, "nothing_saveable")
    assert plain.products() > 0
    assert dots.products() == plain.products()
    assert full.products() > plain.products()
    assert plain.counts[FLASH_OP] == 0
    assert dots.counts[FLASH_OP] == full.counts[FLASH_OP] == SMALL["num_self_attends_per_block"]
    no_batch, _ = _backward_counts(True, "dots_with_no_batch_dims_saveable")
    assert plain.products() <= no_batch.products() <= full.products()
    everything, _ = _backward_counts(True, "everything_saveable")
    assert everything.counts[FLASH_OP] == 0 and everything.products() == plain.products()
    for name, want in g_plain.items():
        assert torch.equal(g_dots[name], want), name
        assert torch.equal(g_full[name], want), name


def test_unknown_remat_policy_names_raise():
    for name in ("save_only_these_names", "offload_dot_with_no_batch_dims", "dots"):
        assert hasattr(jax.checkpoint_policies, name) or name == "dots"
        with pytest.raises(ValueError, match="dots_saveable"):
            port_config.Policy(remat_policy=name)
    for name in port_config.REMAT_POLICIES:
        assert hasattr(jax.checkpoint_policies, name), name
        assert port_config.Policy(remat_policy=name).remat_policy == name
