"""Mid-training resume of the port (`--checkpoint-every`, `--resume`):
the archive's container and meta against the JAX package's, its leaves
against `model_{i}.npz`, the behaviours of `tests/test_resume_precision.py`,
a member stopped after its second epoch and resumed equal to an
uninterrupted one to the bit, and the member-level skip of a finished
member."""
import dataclasses
import io
import json
import pathlib
import sys
from contextlib import redirect_stdout

import numpy as np
import pytest

torch = pytest.importorskip("torch")

sys.path.insert(0, str(pathlib.Path(__file__).parent))
from synthetic import make_samples  # noqa: E402

from gnnep_tpu.train import artifacts as jart  # noqa: E402
from gnnep_tpu_torch.data.store import GraphStore as PStore  # noqa: E402
from gnnep_tpu_torch.data.store import save_sample, write_index  # noqa: E402
from gnnep_tpu_torch.models.alignn import leaf_names  # noqa: E402
from gnnep_tpu_torch.train import artifacts as part  # noqa: E402
from gnnep_tpu_torch.train import member as pmember  # noqa: E402
from gnnep_tpu_torch.train.config import TrainConfig  # noqa: E402
from gnnep_tpu_torch.train.ensemble import (model_config,  # noqa: E402
                                            prepare, run_training)

SEED = 42


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the suite runs several workers on the machine's
    cores, and torch's default of a thread a core would oversubscribe
    them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _Crash(RuntimeError):
    pass


def _cfg(tmp_path, epochs=4, **kw):
    base = dict(save_dir=str(tmp_path), batch_size=8, epochs=epochs,
                hidden=32, layers=2, heads=2, ensemble_size=2, seed=SEED,
                val_frac=0.2, calib_frac=0.1, test_frac=0.1, scan_steps=2,
                warmup_epochs=1, pack_workers=1, verbose=False)
    base.update(kw)
    return TrainConfig(**base)


@pytest.fixture(scope="module")
def store():
    return PStore.from_samples(make_samples(24, seed=8))


def _train(store, cfg):
    """One member on the CPU → (model, metrics, steps, stdout)."""
    setup = prepare(cfg, store)
    mc = model_config(cfg, setup.store, budget=setup.budget)
    buf = io.StringIO()
    with redirect_stdout(buf):
        model, metrics, steps = pmember.train_member(
            setup.store, cfg, mc, setup.transformer, setup.budget, SEED,
            setup.train_idx, setup.val_idx, device="cpu")
    return model, metrics, steps, buf.getvalue()


def _crash_after(monkeypatch, epoch):
    """Make the member stop right after it wrote its checkpoint of `epoch`,
    as a crash would leave it."""
    real = pmember.save_pytree

    def saving(path, leaves, meta=None):
        real(path, leaves, meta)
        if meta["epoch"] == epoch:
            raise _Crash(f"stopped after epoch {epoch}")

    monkeypatch.setattr(pmember, "save_pytree", saving)


def _stop_at_2(monkeypatch, store, cfg):
    _crash_after(monkeypatch, 2)
    with pytest.raises(_Crash):
        _train(store, cfg)
    monkeypatch.undo()
    return pmember.resume_path(cfg, SEED)


def test_archive_roundtrip(tmp_path):
    rng = np.random.default_rng(0)
    leaves = [rng.normal(size=(3, 4)).astype(np.float32),
              np.arange(5, dtype=np.int32), torch.ones(2, dtype=torch.uint8),
              np.float32(rng.normal(size=()))]
    path = tmp_path / "state.npz"
    part.save_pytree(path, leaves, meta={"epoch": 7, "best": None})
    assert not (tmp_path / "state.npz.tmp.npz").exists()
    got, meta = part.load_pytree(path, leaves)
    assert meta == {"epoch": 7, "best": None}
    assert part.count_pytree_leaves(path) == 4
    for a, b in zip(leaves, got):
        a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
        assert b.dtype == a.dtype
        np.testing.assert_array_equal(b, a)
    with pytest.raises(ValueError, match="leaves"):
        part.load_pytree(path, leaves[:3])


def test_jax_reads_port_archive(tmp_path):
    """The same container: the JAX package's `load_pytree_meta` reads the
    port's meta, and its `load_pytree` its leaves."""
    leaves = [np.full((2, 2), 1.5, np.float32), np.int32(3)]
    path = tmp_path / "s.npz"
    part.save_pytree(path, leaves, meta={"epoch": 2, "stale": 0})
    assert jart.load_pytree_meta(path) == {"epoch": 2, "stale": 0}
    got, meta = jart.load_pytree(path, leaves)
    np.testing.assert_array_equal(np.asarray(got[0]), leaves[0])
    assert part.load_pytree_meta(path) == meta


def test_checkpoint_leaves_and_meta(tmp_path, store, monkeypatch):
    """The archive's leaves in `RESUME_LAYOUT`: parameters in the leaf
    order of `model_{i}.npz` (equal to `save_member`'s of the same state),
    Adam's count one per step, the generator's state; its meta has every
    key the JAX package writes, which the JAX package reads."""
    cfg = _cfg(tmp_path, checkpoint_every=1)
    kept = {}
    real = pmember.save_pytree

    def saving(path, leaves, meta=None):
        real(path, leaves, meta)
        if meta["epoch"] == 1:
            kept["leaves"] = [np.array(x.detach().cpu() if isinstance(
                x, torch.Tensor) else x) for x in leaves]
            kept["meta"] = json.loads(json.dumps(meta, default=float))
            raise _Crash("stop")

    monkeypatch.setattr(pmember, "save_pytree", saving)
    with pytest.raises(_Crash):
        _train(store, cfg)
    path = pmember.resume_path(cfg, SEED)
    meta = jart.load_pytree_meta(path)
    for key in ("epoch", "stale", "best_mae_global", "best_mae_reference",
                "best", "best_epoch", "has_best", "flat_opt"):
        assert key in meta
    assert meta["epoch"] == 1 and meta["layout"].startswith(
        pmember.RESUME_LAYOUT)
    setup = prepare(cfg, store)
    mc = model_config(cfg, setup.store, budget=setup.budget)
    n = len(leaf_names(mc))
    leaves = kept["leaves"]
    assert len(leaves) == 4 * n + 2 == part.count_pytree_leaves(path)
    model = part.params_from_leaves(leaves[:n], mc)
    part.save_member(tmp_path / "m.npz", model)
    with np.load(tmp_path / "m.npz") as d:
        for i in range(n):
            np.testing.assert_array_equal(d[f"leaf_{i:05d}"], leaves[i])
    steps = int(leaves[4 * n])
    assert steps > 0 and leaves[4 * n].dtype == np.int32
    assert leaves[4 * n + 1].dtype == np.uint8
    # the first moments are not zero after the epoch's steps
    assert any(np.abs(x).sum() > 0 for x in leaves[2 * n:3 * n])


def test_checkpoint_written_and_cleared(tmp_path, store):
    cfg = _cfg(tmp_path, epochs=3, checkpoint_every=1)
    _, metrics, steps, _ = _train(store, cfg)
    assert not pmember.resume_path(cfg, SEED).exists()
    assert np.isfinite(metrics.get("mae", float("nan"))) and steps > 0


def test_resume_continues_from_checkpoint(tmp_path, store, monkeypatch):
    """The behaviour of the JAX package's test: a member stopped after
    epoch 2 and resumed prints 'resumed at epoch 3' and no epoch before."""
    cfg = _cfg(tmp_path, checkpoint_every=1)
    path = _stop_at_2(monkeypatch, store, cfg)
    assert path.exists() and jart.load_pytree_meta(path)["epoch"] == 2
    _, _, _, out = _train(store, dataclasses.replace(cfg, resume=True,
                                                     verbose=True))
    assert "resumed at epoch 3" in out
    assert "Epoch 003" in out and "Epoch 004" in out
    assert "Epoch 002" not in out and "Epoch 001" not in out
    assert "throughput:" in out
    assert not path.exists()


@pytest.mark.parametrize("kind", ["jax_archive", "layout", "leaf_count"])
def test_layout_mismatch_raises(tmp_path, store, monkeypatch, kind):
    """An archive of another layout raises, naming the file, instead of
    falling back to a fresh start (the JAX package's flat_opt guard)."""
    cfg = _cfg(tmp_path, checkpoint_every=1)
    path = _stop_at_2(monkeypatch, store, cfg)
    leaves, meta = part.load_pytree(path, [0] * part.count_pytree_leaves(
        path))
    if kind == "jax_archive":
        meta.pop("layout")
    elif kind == "layout":
        meta["layout"] = meta["layout"].replace("cpu", "cuda")
    else:
        leaves = leaves[:-1]
    part.save_pytree(path, leaves, meta)
    with pytest.raises(RuntimeError, match="resume_member_42"):
        _train(store, dataclasses.replace(cfg, resume=True))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_resumed_member_equals_uninterrupted(tmp_path, store, monkeypatch,
                                             dtype):
    """4 epochs with dropout and jitter on, stopped after epoch 2 (the
    resume file kept, so the LR schedule is the 4-epoch one) and resumed,
    equal an uninterrupted 4-epoch member to the bit: parameters, best
    metrics; the resumed run takes the uninterrupted run's steps less
    those of its first two epochs."""
    cfg = _cfg(tmp_path / "a", checkpoint_every=1, compute_dtype=dtype,
               dropout=0.15, feature_jitter_std=0.1)
    assert cfg.bootstrap
    (tmp_path / "a").mkdir()
    want, want_m, want_steps, _ = _train(store, cfg)
    cfg_b = dataclasses.replace(cfg, save_dir=str(tmp_path / "b"))
    (tmp_path / "b").mkdir()
    steps_2 = {}
    real = pmember.save_pytree

    def saving(path, leaves, meta=None):
        real(path, leaves, meta)
        if meta["epoch"] == 2:
            steps_2["count"] = int(np.asarray(leaves[-2]))
            raise _Crash("stop")

    monkeypatch.setattr(pmember, "save_pytree", saving)
    with pytest.raises(_Crash):
        _train(store, cfg_b)
    monkeypatch.undo()
    got, got_m, got_steps, _ = _train(store, dataclasses.replace(
        cfg_b, resume=True))
    assert got_steps == want_steps - steps_2["count"] > 0
    assert got_m == want_m
    for (n, a), (_, b) in zip(got.named_parameters(),
                              want.named_parameters()):
        assert torch.equal(a, b), n


def _write_data(root, n=24):
    samples = make_samples(n, seed=8)
    for s in samples:
        save_sample(root, s)
    write_index(root, PStore.from_samples(samples))


def test_member_level_resume_skips_finished(tmp_path, monkeypatch):
    """With --resume an ensemble skips a member whose model_{i}.npz exists,
    and retrains one whose file is unreadable."""
    data = tmp_path / "data"
    _write_data(data)
    cfg = _cfg(tmp_path / "ens", epochs=2, data_dir=str(data))
    first = run_training(cfg, device="cpu")
    ens = tmp_path / "ens"
    before = (ens / "model_0.npz").read_bytes()
    (ens / "model_1.npz").write_bytes(b"not an archive")
    trained = []
    real = pmember.train_member

    def counting(*a, **k):
        trained.append(a[5])
        return real(*a, **k)

    import gnnep_tpu_torch.train.ensemble as pens
    monkeypatch.setattr(pens, "train_member", counting)
    buf = io.StringIO()
    with redirect_stdout(buf):
        second = run_training(dataclasses.replace(cfg, resume=True,
                                                  verbose=True), device="cpu")
    assert trained == [SEED + 1007]
    assert "skipping training (resume)" in buf.getvalue()
    assert "unreadable" in buf.getvalue()
    assert (ens / "model_0.npz").read_bytes() == before
    assert second["member_optimizer_steps"][0] == 0
    assert second["member_optimizer_steps"][1] == \
        first["member_optimizer_steps"][1]
    with np.load(ens / "model_1.npz") as d:
        assert "config_json" in d.files
