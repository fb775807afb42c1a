"""Seeded random variables for a JAX module without running its `init`:
`jax.eval_shape` gives the variable tree's shapes and numpy fills it, so a
parity test pays for one compiled `apply` and no `init`. Kernels are
drawn with variance 1 / fan_in, GroupNorm/BatchNorm scales around 1,
biases and everything else small, BN variances positive; so no zero
initialiser hides a mistake in a weight's layout."""
import jax
import numpy as np
from flax.traverse_util import flatten_dict, unflatten_dict


def random_variables(module, *args, seed=0, method=None, **kwargs):
    """(flat {collection: {"a/b/leaf": ndarray}}, variables) for `module`
    called on `args`/`kwargs` (through `method` when given); Python scalars
    among `kwargs` stay static."""
    static = {k: v for k, v in kwargs.items() if v is None or isinstance(v, (bool, int, float, str))}
    traced = {k: v for k, v in kwargs.items() if k not in static}

    def init(key, *a, **k):
        return module.init(key, *a, **k, **static, **({} if method is None else {"method": method}))

    shapes = jax.eval_shape(init, jax.random.PRNGKey(0), *args, **traced)
    rs = np.random.RandomState(seed)
    flat = {}
    for col, tree in shapes.items():
        leaves = {}
        for key, s in flatten_dict(tree, sep="/").items():
            leaf = key.rsplit("/", 1)[-1]
            if leaf == "kernel":
                v = rs.randn(*s.shape) / np.sqrt(np.prod(s.shape[:-1]))
            elif leaf == "scale":
                v = 1.0 + 0.1 * rs.randn(*s.shape)
            elif leaf == "var":
                v = 0.5 + rs.rand(*s.shape)
            elif leaf == "embedding":
                v = rs.randn(*s.shape)
            else:
                v = 0.1 * rs.randn(*s.shape)
            leaves[key] = v.astype(s.dtype)
        flat[col] = leaves
    return flat, {col: unflatten_dict(leaves, sep="/") for col, leaves in flat.items()}
