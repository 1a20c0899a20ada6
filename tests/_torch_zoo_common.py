"""What the port's transformer-zoo tests share: the tiny configurations of
the JAX package's `tests/test_transformer_zoo.py`, seeded numpy inputs, the
Flax init (jitted, from a seeded key) carried into the port's modules
through `utils/weights.py`, and the two tolerance classes.

* f32: max|port - JAX| <= 1e-5 x max(1, max|JAX|) (1e-5 on [0, 1]);
* bf16: 4 bf16 ulps, 4 * 2^-8 = 1.5625e-2 x max(1, max|JAX f32|), of JAX's
  bf16 forward (the parameters and the input cast to bf16 in both).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import torch

from xmm_superres_denoise_torch.utils.weights import params_from_flax

F32_TOL = 1e-5
BF16_TOL = 4 * 2.0**-8

jzoo = importlib.import_module("xmm_superres_denoise_tpu.models")


def x_np(b=1, s=24, c=1, seed=0, lo=0.0, hi=1.0):
    return np.random.default_rng(seed).uniform(lo, hi, (b, s, s, c)).astype(np.float32)


def _jitted(fn, args):
    """`fn(*args)` jitted over the numpy arrays and trees among `args`, the
    other arguments (spatial sizes, None) static."""
    arrays = [i for i, a in enumerate(args) if isinstance(a, (np.ndarray, dict))]

    def call(*traced):
        full = list(args)
        for i, t in zip(arrays, traced):
            full[i] = t
        return fn(*full)

    return jax.jit(call)(*[args[i] for i in arrays])


def jax_init(module, *args, seed=0, with_output=False, **kwargs):
    """The Flax variables of `module` from its jitted init (a seeded
    `unsafe_rbg` key, which compiles in about half the time of the default
    threefry), as numpy; with `with_output`, (f32 output, variables) from one
    compile (`init_with_output`)."""
    key = jax.random.key(seed, impl="unsafe_rbg")
    out, v = _jitted(lambda *a: module.init_with_output(key, *a, **kwargs), args)
    v = jax.tree_util.tree_map(np.asarray, v)
    return (np.asarray(out, np.float32), v) if with_output else v


def jax_apply(module, variables, *args, dtype=jnp.float32, **kwargs):
    """The jitted Flax forward with the float parameters and inputs in
    `dtype`, as f32 numpy."""
    def cast(t):
        t = jnp.asarray(t)
        return t.astype(dtype) if jnp.issubdtype(t.dtype, jnp.floating) else t

    v = jax.tree_util.tree_map(lambda t: np.asarray(cast(t)), variables)
    a = [np.asarray(cast(t)) if isinstance(t, np.ndarray) else t for t in args]
    out = _jitted(lambda v, *a: module.apply(v, *a, **kwargs), [v, *a])
    return np.asarray(out.astype(jnp.float32))


def port(module, variables):
    """`module` with the Flax parameters loaded (strict), in eval mode."""
    module.load_state_dict(params_from_flax(variables["params"], module))
    return module.eval()


def run_port(module, *args, dtype=torch.float32, **kwargs):
    """The port's forward with the module and the float inputs in `dtype`,
    under no_grad, as f32 numpy."""
    module = module.to(dtype)
    a = [torch.from_numpy(t).to(dtype) if isinstance(t, np.ndarray) else t for t in args]
    with torch.no_grad():
        return module(*a, **kwargs).float().numpy()


def check(got, want, tol, what, scale=None):
    """max|got - want| <= tol x max(1, max|scale|) (scale: want), printed."""
    scale = max(1.0, float(np.abs(want if scale is None else scale).max()))
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.abs(got - want).max())
    print(f"{what}: max|port - JAX| {err:.3e} (tol {tol * scale:.3e})")
    assert np.isfinite(got).all() and err <= tol * scale, (what, err)
    return err
