"""The port's host data layer packs array-equal batches to the JAX package's,
and its scalers and store format round-trip against the JAX package's."""
import dataclasses
import pathlib
import sys

import numpy as np
import pytest

sys.path.insert(0, str(pathlib.Path(__file__).parent))
from synthetic import make_samples  # noqa: E402

from gnnep_tpu.data import batching as jb  # noqa: E402
from gnnep_tpu.data import store as js  # noqa: E402
from gnnep_tpu.data import transforms as jt  # noqa: E402
from gnnep_tpu.data.featurize import GraphSample as JSample  # noqa: E402
from gnnep_tpu_torch.data import batching as pb  # noqa: E402
from gnnep_tpu_torch.data import store as ps  # noqa: E402
from gnnep_tpu_torch.data import transforms as pt  # noqa: E402
from gnnep_tpu_torch.data.featurize import GraphSample as PSample  # noqa: E402
from gnnep_tpu_torch.utils.synth import synthetic_samples  # noqa: E402


def _convert(samples, cls):
    return [cls(**{f.name: getattr(s, f.name)
                   for f in dataclasses.fields(cls)}) for s in samples]


def _stores(kind):
    """The same graphs as a JAX store and a port store."""
    if kind == "jax_synthetic":
        samples = make_samples(10, seed=3)
        return (js.GraphStore.from_samples(samples),
                ps.GraphStore.from_samples(_convert(samples, PSample)))
    samples = synthetic_samples(np.random.default_rng(5), 12, mean_atoms=6,
                                degree=4)
    return (js.GraphStore.from_samples(_convert(samples, JSample)),
            ps.GraphStore.from_samples(samples))


def _assert_batches_equal(jbatches, pbatches):
    assert len(jbatches) == len(pbatches) > 0
    for a, b in zip(jbatches, pbatches):
        assert a._fields == b._fields
        for name in a._fields:
            x, y = getattr(a, name), getattr(b, name)
            if x is None or y is None:
                assert x is None and y is None, name
                continue
            assert x.dtype == y.dtype, name
            assert np.array_equal(x, y), name


@pytest.mark.parametrize("kind", ["jax_synthetic", "port_synthetic"])
@pytest.mark.parametrize("batch_size", [3, 5])
def test_budget_and_batches_equal(kind, batch_size):
    jstore, pstore = _stores(kind)
    idx = list(range(jstore.n_graphs))[::-1]
    jbud = jb.BatchBudget.plan(jstore, idx, batch_size)
    pbud = pb.BatchBudget.plan(pstore, idx, batch_size)
    assert dataclasses.asdict(jbud) == dataclasses.asdict(pbud)
    jbatches = jb.epoch_batches(jstore, idx, jbud, shuffle=False)
    pbatches = pb.epoch_batches(pstore, idx, pbud, shuffle=False)
    _assert_batches_equal(jbatches, pbatches)
    # the win64 contract holds on the port's batches as on the JAX ones
    pb.verify_win64(pbatches, pbud)


def test_shuffled_and_parallel_packing_equal():
    jstore, pstore = _stores("port_synthetic")
    idx = range(jstore.n_graphs)
    jbud = jb.BatchBudget.plan(jstore, idx, 4)
    pbud = pb.BatchBudget.plan(pstore, idx, 4)
    kw = dict(shuffle=True, workers=3)
    _assert_batches_equal(
        jb.epoch_batches(jstore, idx, jbud, rng=np.random.default_rng(9), **kw),
        pb.epoch_batches(pstore, idx, pbud, rng=np.random.default_rng(9), **kw))


def test_store_format_round_trips(tmp_path):
    """Written by the port, read by the JAX package, and the reverse."""
    samples = synthetic_samples(np.random.default_rng(2), 4, mean_atoms=5,
                                degree=3)
    for s in samples:
        ps.save_sample(tmp_path / "p", s)
        js.save_sample(tmp_path / "j", _convert([s], JSample)[0])
    ps.write_index(tmp_path / "p", ps.GraphStore.from_samples(samples))
    a = js.GraphStore.load_dir(tmp_path / "p", use_cache=False)
    b = ps.GraphStore.load_dir(tmp_path / "j", use_cache=False)
    for name in js.GraphStore._ARENA_ARRAYS:
        assert np.array_equal(getattr(a, name), getattr(b, name)), name
    assert a.material_ids == b.material_ids
    assert (tmp_path / "p" / "index.json").exists()


def test_scaler_and_log_transform_round_trips():
    jstore, pstore = _stores("port_synthetic")
    train = list(range(0, jstore.n_graphs, 2))
    jsc = jt.FeatureScaler.fit(jstore, train)
    psc = pt.FeatureScaler.fit(pstore, train)
    for k, v in jsc.state_dict().items():
        assert np.array_equal(v, psc.state_dict()[k]), k
    again = pt.FeatureScaler.from_state_dict(psc.state_dict())
    for name in ("node_feats", "global_scalars"):
        assert np.array_equal(getattr(jsc.apply(jstore), name),
                              getattr(again.apply(pstore), name)), name

    y = jstore.y
    jlt, plt_ = jt.LogTransformer.fit(y), pt.LogTransformer.fit(y)
    plt2 = pt.LogTransformer.from_state_dict(plt_.state_dict())
    z = plt2.transform(y)
    assert np.array_equal(z, jlt.transform(y))
    assert np.array_equal(plt2.inverse(z), jlt.inverse(z))
    np.testing.assert_allclose(plt2.inverse(z), y, rtol=1e-5)
