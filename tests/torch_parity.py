"""Shared helpers of the PyTorch-port parity tests (tests/test_torch_*.py).

Inputs are made with numpy from fixed seeds and handed to both packages;
results come back as numpy.  The reference (JAX) runs on the CPU as its own
tests run it (tests/conftest.py pins the CPU backend); the port runs on the
CPU too, where its kernel wrappers take their plain PyTorch versions.
Tier-1 runs pytest with several workers, so torch keeps to one thread.
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)


def tt(x, dtype=None):
    """numpy / jax array -> torch CPU tensor (dtype kept unless given)."""
    return torch.as_tensor(np.array(x), dtype=dtype)


def nn(x):
    """torch tensor / jax array -> numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def jax_bits(key, n: int) -> np.ndarray:
    """The reference's int32 random priorities (voxel.py:181)."""
    import jax
    import jax.numpy as jnp

    return np.asarray(jax.random.bits(key, (n,), jnp.uint32).astype(jnp.int32))


def jax_step_priorities(seed: int, shapes):
    """The three priority vectors the reference's step draws from the pack's
    seed (fused.py:712, 357, 734, and the k1 / k2 keys)."""
    import jax

    from dmsa_lidar_slam_tpu_torch.pipeline.fused import StepPriorities

    key = jax.random.PRNGKey(seed)
    k1, k2, _ = jax.random.split(key, 3)
    return StepPriorities(
        preprocess=tt(jax_bits(jax.random.fold_in(key, 917), shapes.raw_cap)),
        static=tt(jax_bits(k1, shapes.n_candidates * shapes.kf_pts_cap)),
        keyframe=tt(jax_bits(k2, shapes.window.n_window_pts)),
    )


def jax_counter_priorities(counter: int, n: int):
    """The int32 priorities the reference's DmsaSlam draws for its
    `counter`-th downsampling (slam.py:141-143: jax.random.PRNGKey(counter)
    handed to random_downsample_mask), for the port's DmsaSlam.priorities."""
    import jax

    return tt(jax_bits(jax.random.PRNGKey(counter), n))


def require_cuda():
    """Skip (inside the test, never at import) when there is no CUDA card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: python -m pytest --noconftest -m gpu tests/test_torch_kernels.py")
