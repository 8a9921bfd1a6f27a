"""Carry the port's choice maps across to ``genjax_tpu`` for
the tests that hold the combinators against the reference: the same
choices, scored by both packages."""

import jax.numpy as jnp
import numpy as np
import torch
import torch.utils._pytree as pytree

import genjax_tpu as gj
import genjax_tpu_torch as g
from genjax_tpu.generative import choice_map as jchm
from genjax_tpu_torch.generative import choice_map as tchm


def to_jax_value(v):
    """A port value (tensor, Python number, ``Mask``) as the reference's."""
    if isinstance(v, g.Mask):
        return gj.Mask(to_jax_value(v.value), to_jax_value(v.flag))
    if isinstance(v, torch.Tensor):
        return jnp.asarray(v.detach().cpu().numpy())
    return v


def to_jax(chm):
    """A port choice map as the reference's, node for node."""
    if isinstance(chm, tchm.EmptyChm):
        return gj.ChoiceMap.empty()
    if isinstance(chm, tchm.ValueChm):
        return jchm.ValueChm(to_jax_value(chm.v))
    if isinstance(chm, tchm.StaticChm):
        return jchm.StaticChm.build({k: to_jax(s) for k, s in zip(chm.keys, chm.submaps)})
    if isinstance(chm, tchm.IndexedChm):
        return jchm.IndexedChm.build(to_jax(chm.inner), to_jax_value(chm.idx))
    if isinstance(chm, tchm.MaskedChm):
        return to_jax(chm.inner).mask(to_jax_value(chm.flag))
    if isinstance(chm, tchm.SwitchChm):
        return gj.ChoiceMap.switch(to_jax_value(chm.idx), [to_jax(b) for b in chm.branches])
    if isinstance(chm, tchm.OrChm):
        return to_jax(chm.c1) | to_jax(chm.c2)
    raise TypeError(f"no bridge for {type(chm).__name__}")


def leaves_close(a, b, atol=1e-5):
    """Two trees of numbers (one package's each) agree leaf by leaf."""
    la = [np.asarray(x.detach().cpu() if isinstance(x, torch.Tensor) else x, np.float64)
          for x in pytree.tree_leaves(a)]
    import jax

    lb = [np.asarray(x, np.float64) for x in jax.tree_util.tree_leaves(b)]
    assert len(la) == len(lb), (len(la), len(lb))
    for x, y in zip(la, lb):
        np.testing.assert_allclose(x, y, atol=atol, rtol=1e-5)
