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
    (1, 40, jnp.float32), (32, 24, jnp.float32), (16, 64, jnp.bfloat16),
    (32, 8, jnp.bfloat16), (1, 16, jnp.bfloat16)])
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


def test_cpu_path_checks_the_range_at_the_call():
    """On the CPU the range check raises at the call; the refused-index counter belongs
    to the kernel and stays untouched."""
    W = torch.zeros((4, 128), dtype=torch.bfloat16)
    r = torch.zeros((3, 128), dtype=torch.int32)
    with pytest.raises(ValueError, match=r"r spans \[0, 4\]"):
        wg.window_gather(W, r + torch.eye(3, 128, dtype=torch.int32) * 4, r)
    with pytest.raises(ValueError, match=r"c spans \[-1, 0\]"):
        wg.window_gather(W, r, r - torch.eye(3, 128, dtype=torch.int32))
    wg.check_refused()


@pytest.mark.parametrize("m8", [1, 3])
def test_cpu_path_takes_any_number_of_index_rows(m8):
    rng = np.random.default_rng(m8)
    W = torch.from_numpy(rng.normal(size=(32, 128)).astype(np.float32))
    r = torch.from_numpy(rng.integers(0, 32, (m8, 128)).astype(np.int32))
    c = torch.from_numpy(rng.integers(0, 128, (m8, 128)).astype(np.int32))
    got = wg.window_gather(W, r[:, ::1], c)
    assert torch.equal(got, W[r.long(), c.long()])
    # an offset view (not 16-byte aligned) is the kernel's to refuse, not the plain version's
    flat = torch.zeros(m8 * 128 + 1, dtype=torch.int32)
    flat[1:] = r.reshape(-1)
    assert torch.equal(wg.window_gather(W, flat[1:].view(m8, 128), c), got)
