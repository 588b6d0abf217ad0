"""The block graphs of the port's regions against the JAX reference.

For each of the 31 ported regions: the graph's block names and edges
equal the reference's, and ``block_of`` gives the reference's block on
every state of the fault-free trajectory, and on that trajectory's middle
state with each word ``block_of`` reads flipped at low and high bits (the
out-of-range control values a fault makes).  The reference's
``block_of`` runs once a region, vmapped over the stacked states.
"""

import numpy as np
import pytest
import torch

from coast_tpu_torch.models import REGISTRY
from coast_tpu_torch.ops.fused_step import _ReadRecorder

torch.set_num_threads(1)

# Every region with a block graph: the training regions and the stencil
# have none, in the reference too (tests/test_torch_train.py and
# tests/test_torch_stencil.py hold that).
GRAPH_NAMES = sorted(set(REGISTRY) - {"train_mlp", "train_mlp_adam",
                                      "stencil"})


def _states(region):
    """The leaves ``block_of`` reads, on every state of the fault-free
    trajectory (one row each), and those leaves' names."""
    st = {k: v.unsqueeze(0) for k, v in region.init("cpu").items()}
    step = region.bound_step()
    states, read = [], set()
    for t in range(region.max_steps):
        rec = _ReadRecorder(st)
        region.graph.block_of(rec)
        read |= rec.read
        states.append(st)
        if bool(region.done(st)[0]):
            break
        st = {**st, **step(st, t)}
    return [{k: s[k] for k in sorted(read)} for s in states]


def _flipped(state, bits=(0, 1, 5, 16, 30, 31)):
    """``state`` with word 0 of each leaf flipped at each of ``bits``."""
    out = []
    for name, arr in state.items():
        for bit in bits:
            flat = arr.reshape(-1).view(torch.int32).clone()
            flat[0] ^= np.int32(np.uint32(1 << bit).view(np.int32)).item()
            out.append({**state, name: flat.view(arr.dtype).reshape(
                arr.shape)})
    return out


@pytest.mark.parametrize("name", GRAPH_NAMES)
def test_graph_and_block_of_equal_reference(name):
    import jax
    import jax.numpy as jnp
    from coast_tpu.models import REGISTRY as JREGISTRY
    region, jregion = REGISTRY[name](), JREGISTRY[name]()
    graph, jgraph = region.graph, jregion.graph
    assert graph.names == jgraph.names
    assert [tuple(e) for e in graph.edges] == [tuple(e)
                                               for e in jgraph.edges]
    graph.validate()

    states = _states(region)
    states += _flipped(states[len(states) // 2])
    got = np.concatenate([graph.block_of(s).numpy() for s in states])
    assert got.dtype == np.int32

    def host(name, rows):
        arr = torch.cat(rows).numpy()
        return arr.view(np.uint32) if region.spec[name].unsigned else arr

    stacked = {k: jnp.asarray(host(k, [s[k] for s in states]))
               for k in states[0]}
    want = np.asarray(jax.vmap(jgraph.block_of)(stacked)).astype(np.int32)
    np.testing.assert_array_equal(got, want)
