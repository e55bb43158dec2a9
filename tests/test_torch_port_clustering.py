"""The port's clustering toolbox against the JAX package on the CPU, on the
same numpy inputs and fed draws: NMI against sklearn (1e-12), PCA-whitening
(up to each column's sign), k-means from k-means++'s draws (assignments
equal; k-means++ on zero weights picks index 0 on both sides), the k-NN
graph, host and tensor PIC and the PIC class (equal), and
``uniform_label_epoch`` (bit-equal for one numpy generator)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from sklearn.metrics import normalized_mutual_info_score

from audiossl_tpu.objectives import clustering as jcl
from audiossl_tpu_torch.objectives import clustering as cl
from audiossl_tpu_torch.utils.metrics import nmi

TOL = 1e-5  # f32 on both sides, sums in another order


def blobs(seed, n_per=24, k=4, d=16, spread=0.1):
    """k well-separated Gaussian blobs."""
    rng = np.random.default_rng(seed)
    cents = 3.0 * rng.standard_normal((k, d))
    x = np.concatenate([c + spread * rng.standard_normal((n_per, d)) for c in cents]).astype(np.float32)
    return x[rng.permutation(len(x))]


def conditioned(x, seed, top=8):
    """``x`` moved linearly (its clusters kept) onto an exact covariance
    spectrum: eigenvalues 1.0, 0.9, ..., 0.3 along ``top`` random directions
    and 0.01 along the rest. Eigenvectors of near-equal eigenvalues are
    each library's own choice, and an f32 eigensolver misplaces an
    eigenvector by about eps * |cov| / gap: these gaps keep that below 1e-6
    (and the whitening's 1e-10 floor away)."""
    rng = np.random.default_rng(seed)
    x = np.asarray(x, np.float64)
    xc = x - x.mean(axis=0)
    white = xc @ np.linalg.inv(np.linalg.cholesky(xc.T @ xc / len(x))).T  # covariance exactly I
    d = x.shape[1]
    eig = np.concatenate([np.linspace(1.0, 0.3, top), np.full(d - top, 0.01)])
    q, _ = np.linalg.qr(rng.standard_normal((d, d)))
    return (white * np.sqrt(eig) @ q.T).astype(np.float32)


def jax_kmeans_draws(key, n, k):
    """The draws jax's kmeans_l2 makes from ``key``: the first index and the
    uniform behind each ``jax.random.choice(p=...)``."""
    key, k0 = jax.random.split(jnp.asarray(key))
    first = int(jax.random.randint(k0, (), 0, n))
    u = []
    for _ in range(1, k):
        key, sub = jax.random.split(key)
        u.append(float(jax.random.uniform(sub, (), jnp.float32)))
    return first, np.asarray(u, np.float32)


@pytest.mark.parametrize("case", ["random", "nested", "one_class", "split"])
def test_nmi_matches_sklearn(case):
    rng = np.random.default_rng(5)
    a = rng.integers(0, 7, 300)
    b = {"random": rng.integers(0, 11, 300), "nested": a // 2 + 3 * (rng.random(300) < 0.1),
         "one_class": np.zeros(300, int), "split": np.arange(300)}[case]
    for x, y in ((a, b), (b, a), (b, b)):
        assert abs(nmi(x, y) - normalized_mutual_info_score(x, y)) <= 1e-12


def test_pca_whiten_matches_jax_up_to_column_signs():
    x = conditioned(blobs(0, d=12), 0)
    got = cl.pca_whiten(x, dim=8).numpy()
    want = np.asarray(jcl.pca_whiten(x, dim=8))
    signs = np.sign(np.sum(got * want, axis=0))
    assert np.all(signs != 0)
    np.testing.assert_allclose(got * signs, want, atol=TOL, rtol=0)
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, atol=TOL)


@pytest.mark.parametrize("n_iters", [1, 20])
def test_kmeans_from_fed_draws_matches_jax(n_iters):
    x = cl.pca_whiten(blobs(1), dim=8).numpy()  # whitened as Kmeans feeds it
    key = jax.random.key(3)
    a_j, c_j, obj_j = jcl.kmeans_l2(jnp.asarray(x), 6, key, n_iters=n_iters)
    first, u = jax_kmeans_draws(key, len(x), 6)
    a, c, obj = cl.kmeans_l2(torch.from_numpy(x), 6, first, u, n_iters=n_iters)
    np.testing.assert_array_equal(a.numpy(), np.asarray(a_j))
    np.testing.assert_allclose(c.numpy(), np.asarray(c_j), atol=TOL, rtol=0)
    assert abs(float(obj) - float(obj_j)) <= TOL * abs(float(obj_j))


def test_kmeans_pp_on_zero_weights_picks_index_zero_as_jax():
    """Two points, each repeated: after they are picked every D^2 weight is
    0, jax.random.choice then returns index 0 (a zero cumulative sum), and so
    does the port, where torch.multinomial would raise."""
    rng = np.random.default_rng(4)
    pts = rng.standard_normal((2, 8)).astype(np.float32)
    x = pts[np.array([1, 0, 1, 1, 0, 0, 1, 0])]
    key = jax.random.key(7)
    a_j, c_j, _ = jcl.kmeans_l2(jnp.asarray(x), 4, key, n_iters=1)
    first, u = jax_kmeans_draws(key, len(x), 4)
    a, c, _ = cl.kmeans_l2(torch.from_numpy(x), 4, first, u, n_iters=1)
    np.testing.assert_array_equal(a.numpy(), np.asarray(a_j))
    np.testing.assert_array_equal(c.numpy(), np.asarray(c_j))
    # seeding alone: the third and fourth picks are x[0]
    _, seeded, _ = cl.kmeans_l2(torch.from_numpy(x), 4, first, u, n_iters=0)
    np.testing.assert_array_equal(seeded[2:].numpy(), np.stack([x[0], x[0]]))
    with pytest.raises(RuntimeError):
        torch.multinomial(torch.zeros(8), 1)


def test_kmeans_class_matches_jax():
    """JAX's Kmeans (PCA-whitening, then k-means from jax.random.key(seed))
    against the port's whitening and k-means fed the same draws: the same
    partition, since L2 distances do not see the columns' signs. The port's
    own Kmeans draws from np.random.default_rng(seed) and lists every point."""
    x = conditioned(blobs(2, k=3, d=12), 2)
    ref = jcl.Kmeans(3, pca_dim=8, seed=0)
    ref_loss = ref.cluster(x)
    first, u = jax_kmeans_draws(jax.random.key(0), len(x), 3)
    a, _, loss = cl.kmeans_l2(cl.pca_whiten(x, 8), 3, first, u)
    assert [list(np.flatnonzero(a.numpy() == c)) for c in range(3)] == ref.images_lists
    assert abs(float(loss) - ref_loss) <= TOL * abs(ref_loss)
    km = cl.Kmeans(3, pca_dim=8, seed=0)
    km.cluster(x)
    assert sorted(sum(km.images_lists, [])) == list(range(len(x)))
    first, u = cl.kmeans_draws(len(x), 3, np.random.default_rng(0))
    a, _, _ = cl.kmeans_l2(cl.pca_whiten(x, 8), 3, first, u)
    assert [list(np.flatnonzero(a.numpy() == c)) for c in range(3)] == km.images_lists


def test_knn_graph_and_pic_match_jax():
    x = cl.pca_whiten(conditioned(blobs(3, n_per=20, d=12), 3), dim=8).numpy()
    i_j, d_j = jcl.knn_graph(x, 5)
    i_p, d_p = cl.knn_graph(torch.from_numpy(x), 5)
    np.testing.assert_array_equal(i_p, np.asarray(i_j))
    np.testing.assert_allclose(d_p, np.asarray(d_j), atol=TOL, rtol=0)
    want = jcl.run_pic(np.asarray(i_j), np.asarray(d_j))
    np.testing.assert_array_equal(cl.run_pic(i_p, d_p), want)
    np.testing.assert_array_equal(cl.run_pic_device(i_p, d_p), want)
    np.testing.assert_array_equal(np.asarray(jcl.run_pic_device(np.asarray(i_j), np.asarray(d_j))), want)
    assert want.max() >= 1  # more than one cluster: the pointer chase did something


@pytest.mark.parametrize("device_pic", [False, True])
def test_pic_class_matches_jax(device_pic):
    x = conditioned(blobs(6, n_per=15, k=3, d=12), 6)
    ours, ref = cl.PIC(nnn=4, device=device_pic), jcl.PIC(nnn=4, device=device_pic)
    ours.cluster(x)
    ref.cluster(x)
    assert ours.images_lists == ref.images_lists


@pytest.mark.parametrize("sizes", [(5, 9, 1, 30), (40, 2, 3)])
def test_uniform_label_epoch_is_bit_equal(sizes):
    lists, start = [], 0
    for s in sizes:
        lists.append(list(range(start, start + s)))
        start += s
    lists.insert(1, [])  # an empty cluster is skipped
    for seed in (0, 1):
        got = cl.uniform_label_epoch(lists, start, np.random.default_rng(seed))
        want = jcl.uniform_label_epoch(lists, start, np.random.default_rng(seed))
        assert got.dtype == want.dtype and np.array_equal(got, want)
