"""The port's multi-process training on the CPU over gloo, against the JAX
package on the same mesh shapes.

The port's ranks are processes (this file run as a script, under ``if
__name__ == "__main__"``, one per rank, over a loopback rendezvous); the
reference's mesh is one process over the forced host devices
(tests/conftest.py).  One two-rank launch and one four-rank launch serve
most cases below (module fixtures), each rank writing what it trained to
``.npz`` files that the tests read:

- data parallelism (2, 1), tensor parallelism (1, 2) on the reference's
  alexnet-mini (tests/test_fused_parallel.py), and (2, 2), each against the
  JAX ``FusedTrainer`` on ``make_mesh`` at that test's tolerances (weights
  rtol 1e-4, atol 1e-5; the tp losses 1e-5, 1e-6), with the replicas of
  every data index held equal;
- the reference worker's five full-batch steps (tests/test_distributed.py)
  and its accumulation + bfloat16 storage + restart scenario, at rtol 1e-5,
  atol 1e-6;
- ``StreamTrainer`` under dp against the meshless stream;
- ``distribute`` and the ``Distributable`` hooks, ``CheckpointRecovery``;
- device checkpoints saved at (1, 1), (2, 1), (1, 2) and (2, 2) restored at
  every other layout, bit for bit.

Each rank caps torch at two threads, and every subprocess has its own
``communicate(timeout=...)``."""

from __future__ import annotations

import os
import pickle
import socket
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HYPERS = (0.05, 0.0005, 0.0, 0.9)
TOL = dict(rtol=1e-4, atol=1e-5)
TIGHT = dict(rtol=1e-5, atol=1e-6)
LAYOUTS = ("11", "21", "12", "22")


def _fc(act="linear", hypers=HYPERS):
    return {"kind": "fc", "activation": act, "include_bias": True,
            "hypers": hypers, "hypers_bias": hypers, "config": ()}


def _mlp_case():
    """MNIST's 784-100-10 on seeded data: 600 train rows, minibatch 100."""
    gen = np.random.default_rng(7)
    data = gen.standard_normal((800, 784)).astype(np.float32)
    labels = gen.integers(0, 10, 800).astype(np.int32)
    params = [((gen.standard_normal((784, 100)) * 0.05).astype(np.float32),
               np.zeros(100, np.float32)),
              ((gen.standard_normal((100, 10)) * 0.1).astype(np.float32),
               np.zeros(10, np.float32))]
    vels = [tuple(np.zeros_like(a) for a in p) for p in params]
    return {"layers": [_fc("tanh"), _fc()], "loss": "softmax",
            "params": params, "vels": vels, "data": data, "labels": labels,
            "idx": np.arange(200, 800), "batch": 100}


def _small_fc_case(seed):
    """The reference worker's softmax fc: 64 rows of 32 features, 5
    classes (tests/_distributed_worker.py)."""
    rng = np.random.default_rng(seed)
    data = rng.standard_normal((64, 32)).astype(np.float32)
    labels = rng.integers(0, 5, 64).astype(np.int32)
    w0 = (rng.standard_normal((32, 5)) * 0.1).astype(np.float32)
    hyp = (0.05, 0.0, 0.0, 0.9)
    return {"layers": [_fc(hypers=hyp)], "loss": "softmax",
            "params": [(w0, np.zeros(5, np.float32))],
            "vels": [(np.zeros_like(w0), np.zeros(5, np.float32))],
            "data": data, "labels": labels}


def _layer(kind, act="linear", **cfg):
    return {"kind": kind, "activation": act, "include_bias": True,
            "hypers": HYPERS, "hypers_bias": HYPERS,
            "config": tuple(sorted(cfg.items()))}


def _draws_case():
    """A conv net whose every counter-keyed draw runs on a sharded step:
    a stochastic pool and dropout over a channel-sharded image, dropout
    after fc; an LRN between a split-output conv and a split-input one."""
    gen = np.random.default_rng(11)
    layers = [_layer("conv", "strict_relu", stride=1, padding=1),
              _layer("lrn", n=5, alpha=1e-4, beta=0.75, k=2.0),
              _layer("max_pool", ksize=2, stride=2, padding=0),
              _layer("conv", "strict_relu", stride=1, padding=1),
              _layer("conv", "strict_relu", stride=1, padding=1),
              _layer("stochastic_pool", ksize=2, stride=2, padding=0,
                     seed=3, unit_id=7),
              _layer("dropout", ratio=0.5, seed=4, unit_id=9),
              _layer("fc", "strict_relu"),
              _layer("dropout", ratio=0.3, seed=4, unit_id=11),
              _layer("fc")]
    shapes = [(3, 3, 3, 8), None, None, (3, 3, 8, 12), (3, 3, 12, 8), None,
              None, (2 * 2 * 8, 16), None, (16, 5)]
    params = [(None, None) if sh is None else
              ((gen.standard_normal(sh) * 0.2).astype(np.float32),
               (gen.standard_normal(sh[-1]) * 0.1).astype(np.float32))
              for sh in shapes]
    vels = [tuple(None if a is None else np.zeros_like(a) for a in p)
            for p in params]
    return {"layers": layers, "loss": "softmax", "params": params,
            "vels": vels,
            "data": gen.standard_normal((96, 8, 8, 3)).astype(np.float32),
            "labels": gen.integers(0, 5, 96).astype(np.int32),
            "idx": np.arange(16, 80), "batch": 16}


def _augment_case():
    """MNIST-like rows at a decode size of 10×10, cropped and mirrored on
    the device to 8×8 before a softmax fc."""
    gen = np.random.default_rng(12)
    w = (gen.standard_normal((64, 10)) * 0.1).astype(np.float32)
    return {"layers": [_layer("fc")], "loss": "softmax",
            "params": [(w, np.zeros(10, np.float32))],
            "vels": [(np.zeros_like(w), np.zeros(10, np.float32))],
            "data": gen.standard_normal((64, 10, 10, 1)).astype(np.float32),
            "labels": gen.integers(0, 10, 64).astype(np.int32),
            "idx": np.arange(64), "batch": 16}


def _crop():
    from znicz_tpu_torch.loader.augment import RandomCropFlip
    return RandomCropFlip((8, 8), mirror=True, seed=77)


def _mini_case():
    """The reference's alexnet-mini (tests/test_fused_parallel.py
    ``_conv_workflow``): conv, LRN→pool pairs, dropout, fc."""
    from znicz_tpu import prng as ref_prng
    from znicz_tpu.backends import Device
    from znicz_tpu.config import root as ref_root
    from znicz_tpu.models import alexnet
    from znicz_tpu.parallel import extract_model
    saved = ref_root.alexnet.to_dict()
    try:
        ref_root.alexnet.synthetic.update({"n_train": 64, "n_valid": 32,
                                           "n_test": 0})
        ref_root.alexnet.update({"minibatch_size": 32, "size": 67,
                                 "n_classes": 8})
        ref_root.alexnet.layers = alexnet.make_layers(
            n_classes=8, widths=(8, 16, 8, 8, 8, 32, 16))
        ref_prng.seed_all(99)
        wf = alexnet.AlexNetWorkflow()
        wf.initialize(device=Device.create("xla"))
    finally:
        ref_root.alexnet.update(saved)
    spec, params, vels = extract_model(wf)
    ld = wf.loader
    return {"layers": [{"kind": la.kind, "activation": la.activation,
                        "include_bias": la.include_bias,
                        "hypers": la.hypers, "hypers_bias": la.hypers_bias,
                        "config": la.config} for la in spec.layers],
            "loss": spec.loss, "unit_index": spec.unit_index,
            "params": [tuple(None if a is None else np.array(a) for a in p)
                       for p in params],
            "vels": [tuple(None if a is None else np.array(a) for a in v)
                     for v in vels],
            "data": np.asarray(ld.original_data.mem),
            "labels": np.asarray(ld.original_labels.mem),
            "idx": np.arange(32, 96), "batch": 32}


# -- the ranks ----------------------------------------------------------------
def _port(case, spec_dtype=None):
    """(spec, params, vels) of a case in the port's types, on the CPU."""
    import dataclasses

    from znicz_tpu_torch import convert
    spec, params, vels = convert.from_reference(
        case["layers"], case["loss"], case["params"], case["vels"],
        device="cpu", unit_index=case.get("unit_index", ()))
    if spec_dtype is not None:
        spec = dataclasses.replace(spec, storage_dtype=spec_dtype)
    return spec, params, vels


def _whole(tr) -> dict:
    """The trainer's params and vels, whole, as a flat dict of arrays."""
    params, vels = tr.gather_params()
    out = {}
    for group, pairs in (("p", params), ("v", vels)):
        for i, pair in enumerate(pairs):
            for part, t in zip("wb", pair):
                if t is not None:
                    out[f"{group}{i}{part}"] = t.detach().cpu().numpy()
    return out


def _train(case, mesh, epochs=1, accum=1, storage=None, trainer_kw=None):
    import torch

    from znicz_tpu_torch.parallel.fused import FusedTrainer
    spec, params, vels = _port(case, storage)
    tr = FusedTrainer(spec=spec, params=params, vels=vels, device="cpu",
                      mesh=mesh, accum_steps=accum, **(trainer_kw or {}))
    data = torch.from_numpy(case["data"])
    labels = torch.from_numpy(case["labels"])
    losses = []
    for ep in range(epochs):
        m = tr.train_epoch(data, labels, case["idx"], case["batch"],
                           epoch=ep)
        losses.append(m["loss"])
    return tr, np.concatenate(losses)


def _save(path, arrays: dict) -> None:
    np.savez(path, **arrays)


def _checkpoints(case, work, shapes, rank, done) -> None:
    """Save a checkpoint of a one-epoch training at each of ``shapes``,
    then restore every layout's in ``done`` (and these) at each of
    ``shapes``, writing the whole state each time."""
    from znicz_tpu_torch.parallel import checkpoint, mesh as mesh_lib
    for shape in shapes:
        mesh = mesh_lib.resolve_mesh(shape, device="cpu")
        tr, _ = _train(case, mesh)
        tag = f"{shape[0]}{shape[1]}"
        ck = checkpoint.TrainerCheckpointer(os.path.join(work, "ck" + tag),
                                            mesh=mesh)
        ck.save(tr, 1)
        ck.close()
        whole = _whole(tr)
        if rank == 0:
            _save(os.path.join(work, f"saved_{tag}.npz"), whole)
    _restore_at(case, work, shapes, rank,
                [*done, *(f"{s[0]}{s[1]}" for s in shapes)])


def _restore_at(case, work, shapes, rank, sources) -> None:
    """Restore each layout's checkpoint of ``sources`` at each of
    ``shapes`` (not its own), writing the whole state each time."""
    from znicz_tpu_torch.parallel import checkpoint, mesh as mesh_lib
    for shape in shapes:
        mesh = mesh_lib.resolve_mesh(shape, device="cpu")
        tag = f"{shape[0]}{shape[1]}"
        for src in sources:
            if src == tag:
                continue
            spec, params, vels = _port(case)
            from znicz_tpu_torch.parallel.fused import FusedTrainer
            tr = FusedTrainer(spec=spec, params=params, vels=vels,
                              device="cpu", mesh=mesh)
            ck = checkpoint.TrainerCheckpointer(
                os.path.join(work, "ck" + src), mesh=mesh)
            assert ck.restore(tr) == 1
            ck.close()
            whole = _whole(tr)
            if rank == 0:
                _save(os.path.join(work, f"restored_{src}_at_{tag}.npz"),
                      whole)


def _worker_two(work, rank):
    import torch

    from znicz_tpu_torch.parallel import distributed, mesh as mesh_lib
    cases = pickle.load(open(os.path.join(work, "cases.pkl"), "rb"))
    out = {}
    # data parallelism: every rank keeps its replica
    tr, losses = _train(cases["mlp"], (2, 1))
    _save(os.path.join(work, f"dp_rank{rank}.npz"),
          {"loss": losses, **_whole(tr)})
    # tensor parallelism on alexnet-mini, two epochs
    mini = cases["mini"]
    tr, losses = _train(mini, (1, 2), epochs=2)
    whole = _whole(tr)
    out["tp"] = {"loss": losses, **whole}
    # every counter-keyed draw on sharded steps, and the device crop
    for shape in ((2, 1), (1, 2)):
        tr, losses = _train(cases["draws"], shape, epochs=2)
        out[f"draws{shape[0]}{shape[1]}"] = {"loss": losses, **_whole(tr)}
    tr, losses = _train(cases["augment"], (2, 1), epochs=2,
                        trainer_kw={"augment": _crop()})
    out["augment"] = {"loss": losses, **_whole(tr)}
    # the reference worker's five full-batch steps under dp
    fc = cases["plain"]
    from znicz_tpu_torch.parallel.fused import FusedTrainer
    spec, params, vels = _port(fc)
    tr = FusedTrainer(spec=spec, params=params, vels=vels, device="cpu",
                      mesh=(2, 1))
    for step in range(5):
        tr.train_epoch(torch.from_numpy(fc["data"]),
                       torch.from_numpy(fc["labels"]), np.arange(64), 64,
                       epoch=step)
    out["plain"] = _whole(tr)
    # StreamTrainer under dp
    from znicz_tpu_torch.loader.streaming import RecordLoader
    from znicz_tpu_torch.parallel.stream import StreamTrainer
    from znicz_tpu_torch.workflow import Workflow
    mlp = cases["mlp"]
    ld = RecordLoader(Workflow(name="w"), train_paths=cases["records"],
                      minibatch_size=mlp["batch"])
    ld.initialize("cpu")
    spec, params, vels = _port(mlp)
    st = StreamTrainer(spec=spec, params=params, vels=vels, device="cpu",
                       loader=ld, mesh=(2, 1), prefetch_depth=1)
    m = st.train_epoch(None, None, mlp["idx"], mlp["batch"], epoch=0)
    out["stream"] = {"loss": m["loss"], **_whole(st)}
    # distribute and the Distributable hooks
    out["distribute"] = _distribute()
    # CheckpointRecovery: process 0 saves and quarantines
    out["recovery"] = _recovery(work, rank)
    # checkpoints across layouts
    _checkpoints(mlp, work, [(2, 1), (1, 2)], rank, ["11"])
    mesh = mesh_lib.resolve_mesh((2, 1), device="cpu")
    out["gauge"] = _gauges()
    del mesh
    if rank == 0:
        with open(os.path.join(work, "two.pkl"), "wb") as fh:
            pickle.dump(out, fh)
    distributed.process_count()


def _gauges() -> dict:
    from znicz_tpu_torch.telemetry.registry import REGISTRY
    g = REGISTRY.gauge("mesh_axis_size")
    return {axis: g.value(axis=axis, site="train")
            for axis in ("data", "model")}


def _distribute() -> dict:
    import torch

    from znicz_tpu_torch import prng
    from znicz_tpu_torch.config import root
    from znicz_tpu_torch.models import mnist
    from znicz_tpu_torch.parallel import distributed
    from znicz_tpu_torch.parallel.fused import FusedTrainer
    root.mnist.synthetic.update({"n_train": 192, "n_valid": 64,
                                 "n_test": 0})
    root.mnist.minibatch_size = 64
    prng.seed_all(5)
    wf = mnist.MnistWorkflow()
    wf.initialize(device="cpu")
    payloads = {u.name: u.generate_data_for_slave() for u in wf.units}
    loaders = sorted(n for n, p in payloads.items() if p)
    payload = payloads[wf.loader.name]
    local, total = payload["original_data"]
    rec = {"loaders": loaders, "loader": wf.loader.name,
           "keys": sorted(payload), "local_rows": len(local),
           "total": total, "total_samples": wf.loader.total_samples}
    data = wf.loader.original_data.clone()
    labels = wf.loader.original_labels.clone()
    spec = wf.spec
    params, vels = wf.spec_rows(wf.params), wf.spec_rows(wf.vels)
    idx = np.arange(192) + 64
    local_tr = FusedTrainer(spec=spec, params=params, vels=vels,
                            device="cpu")
    m_local = local_tr.train_epoch(data, labels, idx, 64)
    mesh = distributed.global_mesh(device="cpu")
    rec["report"] = distributed.distribute(wf, mesh)
    shard = wf.loader.original_data
    rec["shard"] = (type(shard).__name__, shard.start, shard.total,
                    int(shard.rows.shape[0]))
    dist_tr = FusedTrainer(spec=spec, params=params, vels=vels,
                           device="cpu", mesh=mesh)
    m_dist = dist_tr.train_epoch(wf.loader.original_data,
                                 wf.loader.original_labels, idx, 64)
    rec["gathered_equal"] = bool(torch.equal(
        dist_tr._place(wf.loader.original_data), data))
    rec["loss"] = (m_local["loss"], m_dist["loss"])
    rec["w"] = [(a[0].numpy(), b[0].numpy()) for a, b in
                zip(local_tr.params, dist_tr.params) if a[0] is not None]
    return rec


def _recovery(work, rank) -> dict:
    import torch.distributed as dist

    from znicz_tpu_torch import prng
    from znicz_tpu_torch.config import root
    from znicz_tpu_torch.models import mnist
    from znicz_tpu_torch.parallel import distributed
    d = os.path.join(work, "recovery")
    prng.seed_all(21)
    root.mnist.synthetic.update({"n_train": 120, "n_valid": 40,
                                 "n_test": 0})
    wf = mnist.MnistWorkflow()
    wf.initialize(device="cpu")
    rec = distributed.CheckpointRecovery(wf, directory=d)
    path = rec.save()
    dist.barrier()
    out = {"saved_by_me": os.path.exists(path) and rank == 0,
           "files": sorted(os.listdir(d))}
    meta = rec.resume_if_found()
    out["meta_epoch"] = None if meta is None else meta.get("epoch_number")
    dist.barrier()
    if rank == 0:                     # rot the only snapshot
        with open(path, "r+b") as fh:
            fh.seek(os.path.getsize(path) // 2)
            byte = fh.read(1)
            fh.seek(-1, os.SEEK_CUR)
            fh.write(bytes([byte[0] ^ 0x01]))
    dist.barrier()
    order = [1, 0]                    # the reader first, then the owner
    for turn in order:
        if rank == turn:
            out["after_rot"] = rec.resume_if_found()
            out["after_rot_files"] = sorted(os.listdir(d))
        dist.barrier()
    return out


def _worker_four(work, rank):
    from znicz_tpu_torch.parallel import distributed
    cases = pickle.load(open(os.path.join(work, "cases.pkl"), "rb"))
    tr, losses = _train(cases["mlp"], (2, 2))
    whole = _whole(tr)
    if rank == 0:
        _save(os.path.join(work, "mesh22.npz"), {"loss": losses, **whole})
    _checkpoints(cases["mlp"], work, [(2, 2)], rank, ["11", "21", "12"])
    distributed.process_count()


def _worker_phase(work, rank, phase):
    """The accumulation + bfloat16 + restart scenario: phase1 trains epoch
    0 and checkpoints, every process exits; phase2 is a fresh process
    group on a fresh port that restores and trains epoch 1."""
    import torch

    from znicz_tpu_torch.parallel import checkpoint, mesh as mesh_lib
    from znicz_tpu_torch.parallel.fused import FusedTrainer
    case = pickle.load(open(os.path.join(work, "cases.pkl"), "rb"))["accum"]
    spec, params, vels = _port(case, "bfloat16")
    mesh = mesh_lib.resolve_mesh((2, 1), device="cpu")
    tr = FusedTrainer(spec=spec, params=params, vels=vels, device="cpu",
                      mesh=mesh, accum_steps=2)
    ck = checkpoint.TrainerCheckpointer(os.path.join(work, "accum"),
                                        mesh=mesh)
    epoch = 0
    if phase == "phase2":
        assert ck.restore(tr) == 0
        epoch = 1
    tr.train_epoch(torch.from_numpy(case["data"]),
                   torch.from_numpy(case["labels"]), np.arange(64), 16,
                   epoch=epoch)
    if phase == "phase1":
        ck.save(tr, 0)
    elif rank == 0:
        np.save(os.path.join(work, "accum_final.npy"),
                tr.params[0][0].numpy())
    ck.close()
    if phase == "phase2":      # after the four-rank launch saved (2, 2)
        mlp = pickle.load(open(os.path.join(work, "cases.pkl"), "rb"))["mlp"]
        _restore_at(mlp, work, [(2, 1), (1, 2)], rank, ["22"])


def _worker(mode, rank, world, port, work):
    import torch
    torch.set_num_threads(2)
    from znicz_tpu_torch.parallel import distributed
    distributed.initialize(f"127.0.0.1:{port}", world, rank, device="cpu")
    try:
        if mode == "two":
            _worker_two(work, rank)
        elif mode == "four":
            _worker_four(work, rank)
        else:
            _worker_phase(work, rank, mode)
    finally:
        distributed.shutdown()


# -- the launches ---------------------------------------------------------
def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _launch(mode, world, work, timeout=300):
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep
               + os.environ.get("PYTHONPATH", ""), OMP_NUM_THREADS="2")
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), mode, str(r),
         str(world), str(port), str(work)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(world)]
    try:
        outs = [p.communicate(timeout=timeout) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, (so, se)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"{mode} rank {r} failed:\n{so}\n{se}"


@pytest.fixture(scope="module")
def work(tmp_path_factory):
    """The cases, the (1, 1) checkpoint and the records, then the two-
    and four-rank launches and the two restart rounds."""
    import torch

    from znicz_tpu_torch.loader.records import write_records
    from znicz_tpu_torch.parallel import checkpoint
    torch.set_num_threads(2)
    work = tmp_path_factory.mktemp("dist")
    mlp = _mlp_case()
    cases = {"mlp": mlp, "mini": _mini_case(), "plain": _small_fc_case(0),
             "draws": _draws_case(), "augment": _augment_case(),
             "accum": _small_fc_case(3),
             "records": write_records(str(work / "mlp.znr"), mlp["data"],
                                      mlp["labels"], shard_size=256)}
    with open(work / "cases.pkl", "wb") as fh:
        pickle.dump(cases, fh)
    tr, _ = _train(mlp, None)
    checkpoint.save_trainer(tr, str(work / "ck11"), step=1)
    _save(str(work / "saved_11.npz"), _whole(tr))
    _launch("two", 2, work)
    _launch("four", 4, work)
    _launch("phase1", 2, work)
    _launch("phase2", 2, work)
    return work


@pytest.fixture(scope="module")
def two(work):
    with open(work / "two.pkl", "rb") as fh:
        return pickle.load(fh)


# -- the JAX package on its mesh ---------------------------------------------
def _ref_trainer(case, mesh_shape, accum=1, storage=None):
    import dataclasses

    from znicz_tpu.parallel import FusedTrainer as RefTrainer
    from znicz_tpu.parallel.fused import LayerSpec, ModelSpec
    from znicz_tpu.parallel.mesh import make_mesh
    spec = ModelSpec(tuple(LayerSpec(**la) for la in case["layers"]),
                     case["loss"], unit_index=case.get("unit_index", ()))
    if storage is not None:
        spec = dataclasses.replace(spec, storage_dtype=storage)

    def copy(pv):
        return [tuple(None if a is None else np.array(a) for a in p)
                for p in pv]
    mesh = None if mesh_shape is None else make_mesh(*mesh_shape)
    return RefTrainer(spec=spec, params=copy(case["params"]),
                      vels=copy(case["vels"]), mesh=mesh,
                      accum_steps=accum)


def _ref_run(case, mesh_shape, epochs=1):
    tr = _ref_trainer(case, mesh_shape)
    losses = []
    for ep in range(epochs):
        m = tr.train_epoch(case["data"], case["labels"], case["idx"],
                           case["batch"], epoch=ep)
        losses.append(np.asarray(m["loss"]))
    return tr, np.concatenate(losses)


def _assert_params(port: dict, ref_tr, **tol):
    n = 0
    for i, (w, b) in enumerate(ref_tr.params):
        if w is None:
            continue
        np.testing.assert_allclose(port[f"p{i}w"], np.asarray(w), **tol)
        if b is not None:
            np.testing.assert_allclose(port[f"p{i}b"], np.asarray(b), **tol)
        n += 1
    assert n > 0


# -- the tests ----------------------------------------------------------------
def test_dp_matches_the_reference_mesh(work):
    mlp = pickle.load(open(work / "cases.pkl", "rb"))["mlp"]
    ref, losses = _ref_run(mlp, (2, 1))
    got = dict(np.load(work / "dp_rank0.npz"))
    np.testing.assert_allclose(got["loss"], losses, **TIGHT)
    _assert_params(got, ref, **TOL)


def test_dp_replicas_stay_equal(work):
    a, b = np.load(work / "dp_rank0.npz"), np.load(work / "dp_rank1.npz")
    assert sorted(a.files) == sorted(b.files)
    for k in a.files:
        np.testing.assert_array_equal(a[k], b[k])


def test_tp_matches_the_reference_mesh_on_alexnet_mini(work, two):
    mini = pickle.load(open(work / "cases.pkl", "rb"))["mini"]
    assert any(la["kind"] == "lrn_pool" for la in mini["layers"])
    assert any(la["kind"] == "dropout" for la in mini["layers"])
    ref, losses = _ref_run(mini, (1, 2), epochs=2)
    np.testing.assert_allclose(two["tp"]["loss"], losses, **TIGHT)
    _assert_params(two["tp"], ref, **TOL)


@pytest.mark.parametrize("shape", ["21", "12"])
def test_draws_on_sharded_steps_match_the_reference_mesh(work, two, shape):
    """Dropout over a channel-sharded image and after fc, a stochastic
    pool over a channel-sharded image: each rank draws the reference's
    global-batch bits at its elements (two epochs, the same tolerances)."""
    case = pickle.load(open(work / "cases.pkl", "rb"))["draws"]
    ref, losses = _ref_run(case, (int(shape[0]), int(shape[1])), epochs=2)
    np.testing.assert_allclose(two["draws" + shape]["loss"], losses, **TIGHT)
    _assert_params(two["draws" + shape], ref, **TOL)


def test_device_crop_under_dp_matches_the_meshless_trainer(work, two):
    """The device crop keys each row by its global index, so a rank's
    share crops as the whole minibatch does."""
    case = pickle.load(open(work / "cases.pkl", "rb"))["augment"]
    tr, losses = _train(case, None, epochs=2,
                        trainer_kw={"augment": _crop()})
    np.testing.assert_allclose(two["augment"]["loss"], losses, **TIGHT)
    for k, v in _whole(tr).items():
        np.testing.assert_allclose(two["augment"][k], v, **TIGHT)


def test_2x2_matches_the_reference_mesh(work):
    mlp = pickle.load(open(work / "cases.pkl", "rb"))["mlp"]
    ref, losses = _ref_run(mlp, (2, 2))
    got = dict(np.load(work / "mesh22.npz"))
    np.testing.assert_allclose(got["loss"], losses, **TIGHT)
    _assert_params(got, ref, **TOL)


def test_five_full_batch_steps_match_the_reference(work, two):
    from znicz_tpu.parallel import fused as ref_fused
    fc = pickle.load(open(work / "cases.pkl", "rb"))["plain"]
    tr = _ref_trainer(fc, None)
    params, vels = tr.params, tr.vels
    for _ in range(5):
        params, vels, _ = ref_fused.train_minibatch(
            tr.spec, params, vels, fc["data"], fc["labels"])
    np.testing.assert_allclose(two["plain"]["p0w"], np.asarray(params[0][0]),
                               **TIGHT)


def test_accum_bf16_restart_matches_the_reference(work):
    case = pickle.load(open(work / "cases.pkl", "rb"))["accum"]
    tr = _ref_trainer(case, None, accum=2, storage="bfloat16")
    tr.train_epoch(case["data"], case["labels"], np.arange(64), 16, epoch=0)
    p2 = [tuple(np.asarray(a) for a in p) for p in tr.params]
    v2 = [tuple(np.asarray(a) for a in v) for v in tr.vels]
    tr2 = _ref_trainer(dict(case, params=p2, vels=v2), None, accum=2,
                       storage="bfloat16")
    tr2.train_epoch(case["data"], case["labels"], np.arange(64), 16,
                    epoch=1)
    np.testing.assert_allclose(np.load(work / "accum_final.npy"),
                               np.asarray(tr2.params[0][0]), **TIGHT)


def test_stream_under_dp_matches_the_meshless_stream(work, two):
    import torch  # noqa: F401

    from znicz_tpu_torch.loader.streaming import RecordLoader
    from znicz_tpu_torch.parallel.stream import StreamTrainer
    from znicz_tpu_torch.workflow import Workflow
    cases = pickle.load(open(work / "cases.pkl", "rb"))
    mlp = cases["mlp"]
    ld = RecordLoader(Workflow(name="w"), train_paths=cases["records"],
                      minibatch_size=mlp["batch"])
    ld.initialize("cpu")
    spec, params, vels = _port(mlp)
    st = StreamTrainer(spec=spec, params=params, vels=vels, device="cpu",
                       loader=ld, prefetch_depth=1)
    m = st.train_epoch(None, None, mlp["idx"], mlp["batch"], epoch=0)
    np.testing.assert_allclose(two["stream"]["loss"], m["loss"], **TIGHT)
    want = _whole(st)
    for k, v in want.items():
        np.testing.assert_allclose(two["stream"][k], v, **TOL)


def test_distribute_publishes_loader_shards(two):
    rec = two["distribute"]
    assert rec["loaders"] == [rec["loader"]]
    assert rec["keys"] == ["original_data", "original_labels"]
    assert rec["total"] == rec["total_samples"] == 256
    assert rec["local_rows"] == 128                 # process 0's half
    assert rec["report"] == {rec["loader"]: ["original_data",
                                             "original_labels"]}
    assert rec["shard"] == ("RowShard", 0, 256, 128)
    assert rec["gathered_equal"]


def test_training_over_distributed_rows_matches_local(two):
    rec = two["distribute"]
    np.testing.assert_allclose(rec["loss"][1], rec["loss"][0], **TIGHT)
    for local, dist in rec["w"]:
        np.testing.assert_allclose(dist, local, **TIGHT)


def test_checkpoint_recovery_saves_and_quarantines_on_process_0(two):
    rec = two["recovery"]
    assert rec["saved_by_me"]
    assert any(f.startswith("recovery_current.npz") for f in rec["files"])
    assert rec["meta_epoch"] is not None
    # the reader skipped the rotten snapshot and left it; the owner
    # quarantined it
    assert rec["after_rot"] is None
    files = rec["after_rot_files"]
    assert any(".corrupt" in f for f in files), files


def test_mesh_gauge_records_the_running_layout(two):
    assert two["gauge"] == {"data": 2, "model": 1}


@pytest.mark.parametrize("src,dst", [(s, d) for s in LAYOUTS
                                     for d in LAYOUTS if s != d])
def test_checkpoints_cross_layouts_bit_equal(work, src, dst):
    saved = np.load(work / f"saved_{src}.npz")
    if dst == "11":
        from znicz_tpu_torch.parallel import checkpoint
        mlp = pickle.load(open(work / "cases.pkl", "rb"))["mlp"]
        from znicz_tpu_torch.parallel.fused import FusedTrainer
        spec, params, vels = _port(mlp)
        tr = FusedTrainer(spec=spec, params=params, vels=vels, device="cpu")
        assert checkpoint.restore_trainer(tr, str(work / f"ck{src}")) == 1
        got = _whole(tr)
    else:
        got = dict(np.load(work / f"restored_{src}_at_{dst}.npz"))
    assert sorted(got) == sorted(saved.files)
    for k in saved.files:
        np.testing.assert_array_equal(got[k], saved[k])


if __name__ == "__main__":
    _worker(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]),
            int(sys.argv[4]), sys.argv[5])
