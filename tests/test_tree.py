import numpy as np
import jax.numpy as jnp

from spcbpt_tpu.train import classify, tree


def test_octree_learns_centroid_labels():
    """Build the octree from nearest-centroid labels (the reference's
    pipeline) and check it reproduces them with high accuracy, as the
    reference's acc printout expects (classTree_host.h:392)."""
    rng = np.random.default_rng(0)
    n = 20000
    pos = rng.uniform(-10, 10, (n, 3)).astype(np.float32)
    # surface-like normals: one of the six axis directions (scene walls),
    # matching the distribution the reference's tree sees
    axes = np.eye(3, dtype=np.float32)
    axes = np.concatenate([axes, -axes])
    normal = axes[rng.integers(0, 6, n)]
    w = rng.uniform(0.1, 1.0, n)

    cls = classify.build_classifier(pos, normal, w, 64)
    labels = np.asarray(classify.classify(cls, jnp.asarray(pos),
                                          jnp.asarray(normal)))
    t = tree.build_tree(pos, normal, labels, w)
    acc = tree.tree_accuracy(t, pos, normal, labels)
    assert acc > 0.90, acc  # reference prints ~99% on its own scene data


def test_octree_pure_regions_exact():
    """Axis-separable labels are learned exactly."""
    rng = np.random.default_rng(1)
    n = 5000
    pos = rng.uniform(0, 8, (n, 3)).astype(np.float32)
    normal = np.tile(np.asarray([0, 0, 1], np.float32), (n, 1))
    labels = (pos[:, 0] > 4).astype(np.int64)
    t = tree.build_tree(pos, normal, labels, np.ones(n))
    acc = tree.tree_accuracy(t, pos, normal, labels)
    assert acc > 0.99, acc


def test_classify_matches_float64_oracle():
    """classify()'s matmul runs at Precision.HIGHEST: the |ci|^2 - 2 p.ci
    score cancels catastrophically at reduced matmul precision (bf16 or a
    GPU's TF32), which flips labels and breaks checkpoints trained under one
    rounding and rendered under another. Labels must match an exact float64
    nearest-centroid oracle."""
    import numpy as np
    import jax.numpy as jnp
    from spcbpt_tpu.train import classify as cl

    rng = np.random.default_rng(5)
    n, k = 4096, 257
    # large coordinate magnitudes + tight centroid spacing = the
    # cancellation regime that bf16 gets wrong
    centers = 1000.0 + rng.normal(size=(k, 3)) * 0.5
    cnorm = rng.normal(size=(k, 3))
    cnorm /= np.linalg.norm(cnorm, axis=-1, keepdims=True)
    pos = 1000.0 + rng.normal(size=(n, 3)) * 0.5
    nrm = rng.normal(size=(n, 3))
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    diag2 = 0.25

    c = cl.Classifier(centers_pos=jnp.asarray(centers, jnp.float32),
                      centers_norm=jnp.asarray(cnorm * 0.5 * diag2,
                                               jnp.float32) / (0.5 * diag2),
                      diag2=jnp.asarray(diag2, jnp.float32))
    got = np.asarray(cl.classify(c, jnp.asarray(pos, jnp.float32),
                                 jnp.asarray(nrm, jnp.float32)))

    # float64 oracle of the same f32-quantized inputs
    p64 = pos.astype(np.float32).astype(np.float64)
    c64 = centers.astype(np.float32).astype(np.float64)
    n64 = (nrm.astype(np.float32) * np.float32(0.5 * diag2)).astype(np.float64)
    cn64 = cnorm.astype(np.float32).astype(np.float64)
    score = (c64 * c64).sum(-1)[None, :] - 2.0 * (
        p64 @ c64.T + n64 @ cn64.T)
    want = score.argmin(axis=-1)
    agree = (got == want).mean()
    assert agree > 0.999, agree
