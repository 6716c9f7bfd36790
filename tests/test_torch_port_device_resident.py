"""The port's device-resident epoch loader (data/device_resident.py) and the
Trainer's pre-grouped path, on the CPU:

* an epoch yields each sample once, in [B,...] batches or [K,B,...]
  groups;
* for the same arrays, seed and epoch, the batches come in the JAX
  package's `DeviceEpochLoader` order, values equal, with pool cycling
  (`steps_per_epoch` past N/B), `shared` constants and mid-epoch
  `skip_batches` included; both refuse the same bad arguments;
* `from_dataset` stages the same arrays reading row by row as reading
  through `read_batch` (non-array fields and `_real_count` dropped, N
  trimmed to a multiple of B·K), and equals JAX's `from_dataset`;
* a Trainer fed pre-grouped groups with `steps_per_call` K equals, bit
  for bit, the host path fed the same batches one by one;
* `rebind_train_loader` rebuilds the schedule for the new length;
* `save_every_steps` with groups writes group-aligned `step`
  checkpoints, and a run resumed from one equals an unbroken run.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from tests.torch_port_common import tmp_path  # noqa: F401  (removes what tests write)


def _arrays(n, seed=0):
    rng = np.random.default_rng(seed)
    return {"id": np.arange(n, dtype=np.int32),
            "x": rng.normal(size=(n, 3, 2)).astype(np.float32)}


def _port(arrays, **kw):
    from automoe_tpu_torch.data.device_resident import DeviceEpochLoader

    return DeviceEpochLoader(arrays, device="cpu", **kw)


def _jax(arrays, **kw):
    from automoe_tpu.data.device_resident import DeviceEpochLoader

    return DeviceEpochLoader(arrays, **kw)


def _epoch(loader, epoch, skip=0):
    loader.set_epoch(epoch, skip_batches=skip)
    return [{k: np.asarray(v) for k, v in g.items()} for g in loader]


@pytest.mark.parametrize("k", [1, 2, 3])
def test_an_epoch_covers_each_sample_once(k):
    n, b = 24, 4
    loader = _port(_arrays(n), batch_size=b, group_size=k, seed=5)
    assert len(loader) == n // b
    for epoch in (0, 1):
        groups = _epoch(loader, epoch)
        assert len(groups) == n // (b * k)
        want = (k, b) if k > 1 else (b,)
        assert all(g["id"].shape == want and g["x"].shape == (*want, 3, 2) for g in groups)
        ids = np.concatenate([g["id"].ravel() for g in groups])
        assert sorted(ids) == list(range(n))
        assert list(ids) != list(range(n))  # shuffled
        for g in groups:  # rows travel with their samples
            np.testing.assert_array_equal(g["x"], _arrays(n)["x"][g["id"]])


@pytest.mark.parametrize("n,b,k,seed,spe", [(24, 4, 1, 0, None), (24, 4, 2, 3, None),
                                            (36, 3, 4, 11, None), (16, 4, 2, 7, 10)])
def test_batch_order_matches_jax(n, b, k, seed, spe):
    arrays = _arrays(n, seed)
    shared = {"c": np.arange(b * 2, dtype=np.float32).reshape(b, 2)}
    kw = dict(batch_size=b, group_size=k, seed=seed, steps_per_epoch=spe, shared=shared)
    mine, ref = _port(arrays, **kw), _jax(arrays, **kw)
    assert len(mine) == len(ref) == (spe or n // b)
    for epoch, skip in ((0, 0), (1, 0), (2, k), (3, 2 * k)):
        got, want = _epoch(mine, epoch, skip), _epoch(ref, epoch, skip)
        assert len(got) == len(want) == len(mine) // k - skip // k
        for g, w in zip(got, want):
            assert sorted(g) == sorted(w)
            for key in w:
                assert g[key].shape == w[key].shape, key
                np.testing.assert_array_equal(g[key], w[key], err_msg=key)
    # skip_batches is one-shot, as a resume's is
    assert len(list(mine)) == len(mine) // k


def test_pool_cycling_repeats_samples_with_fresh_group_orders():
    n, b, k = 16, 4, 2
    loader = _port(_arrays(n), batch_size=b, group_size=k, seed=1, steps_per_epoch=12)
    ids = [g["id"] for g in _epoch(loader, 0)]
    assert len(ids) == 6
    counts = np.bincount(np.concatenate([i.ravel() for i in ids]), minlength=n)
    assert counts.min() >= 1 and counts.sum() == 12 * b


@pytest.mark.parametrize("bad", [
    dict(arrays={}),
    dict(arrays={"a": np.zeros(8), "b": np.zeros(7)}),
    dict(batch_size=3),
    dict(group_size=3),
    dict(steps_per_epoch=5, group_size=2),
    dict(shared={"c": np.zeros((3, 2))}),
], ids=["empty", "ragged", "n-not-multiple", "group-not-multiple", "spe-not-multiple",
        "shared-wrong-batch"])
def test_validation_errors_match_jax(bad):
    kw = dict(arrays=_arrays(16), batch_size=4, group_size=1)
    kw.update(bad)
    arrays = kw.pop("arrays")
    with pytest.raises(ValueError):
        _jax(arrays, **kw)
    with pytest.raises(ValueError):
        _port(arrays, **kw)


def test_skip_batches_must_align_to_the_group():
    loader = _port(_arrays(16), batch_size=2, group_size=2)
    with pytest.raises(ValueError, match="align"):
        loader.set_epoch(0, skip_batches=3)


class _Rows:
    """Samples with a dict, a string and an array field."""

    def __init__(self, n=21, batch=False):
        self.a = _arrays(n, 9)
        if batch:
            self.read_batch = lambda idx: {**{k: v[np.asarray(idx)] for k, v in self.a.items()},
                                           "_real_count": len(idx)}

    def __len__(self):
        return len(self.a["id"])

    def __getitem__(self, i):
        return {**{k: v[i] for k, v in self.a.items()}, "meta": {"i": i}, "name": f"s{i}"}


@pytest.mark.parametrize("k", [1, 2])
def test_from_dataset_rows_equal_read_batch_and_jax(k):
    from automoe_tpu.data.device_resident import DeviceEpochLoader as JaxLoader

    from automoe_tpu_torch.data.device_resident import DeviceEpochLoader

    kw = dict(batch_size=4, group_size=k, seed=2, read_chunk=5, verbose=False)
    rows = DeviceEpochLoader.from_dataset(_Rows(), device="cpu", **kw)
    batched = DeviceEpochLoader.from_dataset(_Rows(batch=True), device="cpu", **kw)
    ref = JaxLoader.from_dataset(_Rows(), **kw)
    assert len(rows) == len(batched) == len(ref) == (21 // (4 * k)) * k
    for epoch in (0, 1):
        a, b, c = _epoch(rows, epoch), _epoch(batched, epoch), _epoch(ref, epoch)
        assert len(a) == len(b) == len(c)
        for x, y, z in zip(a, b, c):
            assert sorted(x) == sorted(y) == sorted(z) == ["id", "x"]
            for key in x:
                np.testing.assert_array_equal(x[key], y[key])
                np.testing.assert_array_equal(x[key], z[key])
    with pytest.raises(ValueError, match="one"):
        DeviceEpochLoader.from_dataset(_Rows(3), batch_size=4, device="cpu", verbose=False)


# ---------------------------------------------------------------------------
# the Trainer's pre-grouped path
# ---------------------------------------------------------------------------

class _Tiny(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.conv = torch.nn.Conv2d(3, 4, 3, padding=1)
        self.bn = torch.nn.BatchNorm2d(4)
        self.drop = torch.nn.Dropout(0.3)
        self.fc = torch.nn.Linear(4, 3)

    def forward(self, x):
        return self.fc(self.drop(torch.relu(self.bn(self.conv(x))).mean(dim=(2, 3))))


def _tiny_loss(model, batch, train, key=None):
    logits = model(batch["image"].permute(0, 3, 1, 2))
    return torch.nn.functional.cross_entropy(logits, batch["label"]), {}


def _samples(n=24, seed=0):
    rng = np.random.default_rng(seed)
    return {"image": rng.normal(size=(n, 6, 6, 3)).astype(np.float32),
            "label": rng.integers(0, 3, n).astype(np.int64)}


class _Unstacked:
    """The host path over a grouped resident loader's batches: each group's
    K batches one by one, as host arrays, in the same order."""

    def __init__(self, resident):
        self.resident = resident

    def __len__(self):
        return len(self.resident)

    def set_epoch(self, epoch, skip_batches=0):
        self.resident.set_epoch(epoch, skip_batches)

    def __iter__(self):
        for g in self.resident:
            for i in range(self.resident.group_size):
                yield {k: v[i].numpy() for k, v in g.items()}


class _CrashAfter:
    """A resident loader that stops the run after `after` groups."""

    def __init__(self, resident, after):
        self.resident, self.after = resident, after
        self.group_size = resident.group_size

    def __len__(self):
        return len(self.resident)

    def set_epoch(self, epoch, skip_batches=0):
        self.resident.set_epoch(epoch, skip_batches)

    def __iter__(self):
        for i, g in enumerate(self.resident):
            if i == self.after:
                raise KeyboardInterrupt("simulated crash")
            yield g


def _trainer(tmp, run, loader, **kw):
    from automoe_tpu_torch.train.loop import TrainConfig, Trainer
    from automoe_tpu_torch.train.workloads import Workload

    val = [{k: v[:4] for k, v in _samples(8, 1).items()}]
    cfg = dict(epochs=2, learning_rate=1e-2, seed=3, device="cpu", run_name=run,
               ckpt_root=str(tmp / "ck"), runs_root=str(tmp / "runs"), log_every=1)
    cfg.update(kw)
    return Trainer(Workload("tiny", _Tiny, _tiny_loss), loader, val, TrainConfig(**cfg))


def _equal_states(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k


@pytest.mark.parametrize("k", [2, 3])
def test_pre_grouped_steps_per_call_equals_host_path(tmp_path, k):
    res = _port(_samples(), batch_size=2, group_size=k, seed=4)
    grouped = _trainer(tmp_path, "grouped", res, steps_per_call=k, ema_decay=0.5)
    host = _trainer(tmp_path, "host", _Unstacked(_port(_samples(), batch_size=2, group_size=k,
                                                       seed=4)),
                    steps_per_call=k, ema_decay=0.5)
    a, b = grouped.fit(), host.fit()
    assert a["best_val_loss"] == b["best_val_loss"]
    assert grouped.optimizer.count == host.optimizer.count == 2 * 12
    _equal_states(grouped.model.state_dict(), host.model.state_dict())
    _equal_states(grouped.optimizer.ema.state_dict(), host.optimizer.ema.state_dict())


def test_rebind_train_loader_rebuilds_the_schedule(tmp_path):
    host = [{k: v[i:i + 2] for k, v in _samples(14).items()} for i in range(0, 14, 2)]
    trainer = _trainer(tmp_path, "rebind", host, epochs=3, schedule="cosine_per_epoch",
                       steps_per_call=3)
    assert (trainer.optimizer.total_steps, trainer.optimizer.steps_per_epoch) == (21, 7)
    count = trainer.optimizer.count = 5  # a restored position survives
    trainer.rebind_train_loader(_port(_samples(12), batch_size=2, group_size=3))
    assert (trainer.optimizer.total_steps, trainer.optimizer.steps_per_epoch) == (18, 6)
    assert trainer.optimizer.count == count
    assert trainer.optimizer.lr_at(6) < trainer.optimizer.lr_at(5)  # epoch 1 starts at 6
    trainer.optimizer.count = 0
    trainer.fit()
    assert trainer.optimizer.count == 18


def test_save_every_steps_with_groups_resumes_like_an_unbroken_run(tmp_path):
    from automoe_tpu_torch.ckpt import load_checkpoint

    def loader():
        return _port(_samples(), batch_size=2, group_size=2, seed=6)

    unbroken = _trainer(tmp_path, "unbroken", loader(), steps_per_call=2, epochs=1)
    unbroken.fit()
    crashed = _trainer(tmp_path, "crash", _CrashAfter(loader(), 4), steps_per_call=2,
                       epochs=1, save_every_steps=3)
    with pytest.raises(KeyboardInterrupt):
        crashed.fit()
    step = load_checkpoint(tmp_path / "ck" / "tiny" / "crash" / "step.pt")
    # groups of 2 batches cross multiples of 3 at 4 and 6: the last checkpoint
    # is the third group's, aligned to the group
    assert (step["epoch"], step["batch_index"], step["step"]) == (0, 6, 6)
    resumed = _trainer(tmp_path, "crash", loader(), steps_per_call=2, epochs=1,
                       resume="full", resume_from="step")
    assert (resumed.start_epoch, resumed.start_batch) == (0, 6)
    resumed.fit()
    assert resumed.optimizer.count == unbroken.optimizer.count == 12
    _equal_states(resumed.model.state_dict(), unbroken.model.state_dict())
