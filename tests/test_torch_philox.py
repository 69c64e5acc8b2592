"""The CPU mirror of B1's normals (``ops/cuda/spectral_train.py``) and the
layout arithmetic of the B1 wrapper (CPU only).

The mirror is held to Random123's known-answer vectors for philox4x32_10;
its uniform and its counter layout (group lo, group hi, step, 0 under the
seed's key) are the kernel's. On the card, ``chip_smoke.py`` phase 3 holds
the kernel's draws to the mirror, and a noisy run of the kernel to the plain
loop fed :func:`mirror_noise`."""

import math

import numpy as np
import pytest
import torch

from projected_langevin_sampling_torch.ops.cuda import spectral_train as tspec

F = 0xFFFFFFFF


@pytest.mark.parametrize(
    "ctr, key, expected",
    [
        ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
        ((F, F, F, F), (F, F), (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
        ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344), (0xA4093822, 0x299F31D0),
         (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
    ],
    ids=["zeros", "ones", "pi"],
)
def test_philox_known_answers(ctr, key, expected):
    assert tuple(int(w) for w in tspec.philox4x32_10(ctr, key)) == expected


def test_philox_vectorised_matches_one_counter_at_a_time():
    rng = np.random.default_rng(0)
    ctr = [rng.integers(0, 2**32, 50, dtype=np.uint64) for _ in range(4)]
    key = (0x12345678, 0x9ABCDEF0)
    words = tspec.philox4x32_10(ctr, key)
    for i in (0, 17, 49):
        one = tspec.philox4x32_10(tuple(int(c[i]) for c in ctr), key)
        assert tuple(int(w[i]) for w in words) == tuple(int(w) for w in one)


def test_uniform_lies_in_zero_one_with_all_ones_at_one():
    bits = np.array([0, 0xFF, 0x100, 0x7FFFFFFF, 0xFFFFFF00, F], dtype=np.uint64)
    u = tspec.uniform24(bits)
    np.testing.assert_array_equal(u, [2.0**-24, 2.0**-24, 2.0**-23, 0.5, 1.0, 1.0])
    rand = tspec.uniform24(np.random.default_rng(1).integers(0, 2**32, 10_000, dtype=np.uint64))
    assert rand.min() > 0 and rand.max() <= 1
    np.testing.assert_array_equal(rand * 2**24, np.round(rand * 2**24))  # 24-bit grid


def _pair(a, b):
    r = math.sqrt(-2.0 * math.log(float(tspec.uniform24(a))))
    theta = 2.0 * math.pi * float(tspec.uniform24(b)) - math.pi
    return r * math.cos(theta), r * math.sin(theta)


@pytest.mark.parametrize("seed, group, step", [(5, 0, 0), (5, 3, 17), (2**40 + 9, 2**33 + 7, 123)])
def test_counter_layout_is_group_lo_hi_step_zero(seed, group, step):
    words = tspec.philox4x32_10((group & F, group >> 32, step, 0), (seed & F, seed >> 32))
    expected = _pair(int(words[0]), int(words[1])) + _pair(int(words[2]), int(words[3]))
    got = tspec.mirror_normals(seed, [group], step)
    np.testing.assert_allclose(got[0], expected, rtol=1e-15, atol=1e-15)
    # another group or step draws other normals
    assert not np.allclose(tspec.mirror_normals(seed, [group + 1], step), got)
    assert not np.allclose(tspec.mirror_normals(seed, [group], step + 1), got)


def test_mirror_normals_follow_the_standard_normal_law():
    z = tspec.mirror_normals(11, np.arange(50_000), 3).reshape(-1)
    n = z.size
    assert abs(z.mean()) < 5 / math.sqrt(n)
    assert abs(z.var() - 1) < 5 * math.sqrt(2 / n)
    r2, theta = tspec.mirror_box_muller(11, np.arange(50_000), 3)
    assert r2.min() >= 0 and theta.min() > -math.pi and theta.max() <= math.pi


@pytest.mark.parametrize("total, blocks", [(1, 1), (2048, 1), (2049, 2), (512 * 1000, 250)])
def test_spectral_grid_covers_every_element_once(total, blocks):
    per_block = tspec.THREADS * tspec.ELEMENTS_PER_THREAD
    assert tspec.ELEMENTS_PER_THREAD % 4 == 0  # whole Philox groups a thread
    assert tspec.num_blocks(total) == blocks
    assert (blocks - 1) * per_block < total <= blocks * per_block


def test_step_energies_sum_the_blocks_of_each_step():
    partials = torch.arange(3 * 5, dtype=torch.float32).reshape(3, 5)  # (blocks, steps)
    got = tspec.step_energies(partials, 4, 2, 1.5)
    expected = torch.tensor([partials[:, s].sum() / 2 + 1.5 for s in range(4)])
    torch.testing.assert_close(got, expected)


@pytest.mark.parametrize("m, j", [(8, 10), (3, 5), (2, 3), (1, 2)])
def test_mirror_noise_puts_entry_k_of_group_g_at_element_4g_plus_k(m, j):
    noise = tspec.mirror_noise(9, m, j, 3)
    assert noise.shape == (3, m, j)
    groups = np.arange(-(-m * j // 4))
    for t in range(3):
        flat = tspec.mirror_normals(9, groups, t).reshape(-1)
        np.testing.assert_array_equal(noise[t].reshape(-1), flat[: m * j])


@pytest.mark.parametrize("noise_scale", [1.0, 0.25, math.sqrt(2e-4)])
def test_plain_loop_on_the_mirror_noise_is_the_update_recursion(noise_scale):
    m, j, steps = 4, 6, 5
    rng = np.random.default_rng(2)
    w0, decay, shift = rng.normal(size=(m, j)), rng.uniform(0.5, 1, m), rng.normal(size=m)
    sigma, b = rng.uniform(1, 2, m), rng.normal(size=m)
    noise = tspec.mirror_noise(4, m, j, steps)
    as_t = torch.from_numpy
    w, energies, _, _ = tspec.spectral_train_reference(
        as_t(w0), as_t(decay), as_t(shift), as_t(sigma), as_t(b), eta=1e-4, patience=math.inf,
        e_const=0.0, num_steps=steps, noise_scale=noise_scale, noise=as_t(noise),
        q_in=torch.eye(m, dtype=torch.float64))
    w_np = w0
    for t in range(steps):
        w_np = decay[:, None] * w_np + shift[:, None] + noise_scale * noise[t]
        e_np = np.mean(0.5 * (sigma[:, None] * w_np**2).sum(0) - b @ w_np)
        assert float(energies[t]) == pytest.approx(e_np, rel=1e-12)
    np.testing.assert_allclose(w.numpy(), w_np, rtol=1e-12, atol=1e-12)
