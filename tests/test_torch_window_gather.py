"""Port parity of ``window_gather``: the port's plain version (what the wrapper runs for
CPU tensors) against the JAX package's Pallas kernel in interpret mode, bit for bit (it
is a copy), and the wrapper's argument checks. The CUDA kernel's own tests are in
tests/test_torch_cuda.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from palettenerf_tpu.ops.pallas_window_gather import window_gather as jax_window_gather
from palettenerf_torch.ops import window_gather as wg


def _inputs(rows, m8, dtype, seed):
    rng = np.random.default_rng(seed)
    W = rng.normal(size=(rows, 128)).astype(np.float32)
    r = rng.integers(0, rows, (m8, 128)).astype(np.int32)
    c = rng.integers(0, 128, (m8, 128)).astype(np.int32)
    jW = jnp.asarray(W).astype(dtype)
    return jW, torch.from_numpy(np.array(jW.astype(jnp.float32))).to(
        torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32), r, c


@pytest.mark.parametrize("rows,m8,dtype", [
    (8, 100, jnp.float32), (16, 64, jnp.float32),     # tests/test_window_gather.py
    (1, 40, jnp.float32), (32, 24, jnp.float32), (16, 64, jnp.bfloat16)])
def test_plain_version_matches_pallas_interpret_bit_exact(rows, m8, dtype):
    jW, tW, r, c = _inputs(rows, m8, dtype, seed=rows + m8)
    ref = np.asarray(jax_window_gather(jW, jnp.asarray(r), jnp.asarray(c), interpret=True)
                     .astype(jnp.float32))
    before = wg.window_gather.launches
    got = wg.window_gather(tW, torch.from_numpy(r), torch.from_numpy(c))
    assert wg.window_gather.launches == before  # CPU tensors: the plain version, no kernel
    assert got.dtype == tW.dtype and got.shape == (m8, 128)
    np.testing.assert_array_equal(got.float().numpy(), ref)


def test_wrapper_rejects_what_the_kernel_does_not_take():
    W = torch.zeros((8, 128))
    r = torch.zeros((4, 128), dtype=torch.int32)
    with pytest.raises(ValueError, match="outside"):
        wg.window_gather(W, r + 8, r)
    with pytest.raises(ValueError, match="outside"):
        wg.window_gather(W, r, r - 1)
    with pytest.raises(ValueError, match="W"):
        wg.window_gather(torch.zeros((33, 128)), r, r)
    with pytest.raises(ValueError, match="W"):
        wg.window_gather(torch.zeros((8, 64)), r, r)
    with pytest.raises(ValueError, match="r, c"):
        wg.window_gather(W, r, r[:2])
    with pytest.raises(TypeError):
        wg.window_gather(W, r.long(), r)
