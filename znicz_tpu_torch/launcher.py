"""Launcher: the two-file workflow + config entry point (port of
``znicz_tpu/launcher.py``).

``Launcher(workflow, config, ...).run()`` runs the config file against
``root`` (its values beat the module's ``setdefaults``), imports the
workflow module, applies ``--set`` overrides last, seeds every stream and
calls the module's ``run()`` — or, with ``snapshot``, builds and
initializes the module's workflow, loads the snapshot
(``SnapshotterToFile.load``) and trains on from there.  ``profile`` wraps
the run in a ``torch.profiler`` trace, ``timeline_jsonl`` points the fused
loop's per-epoch timeline at a file for this run only.

Multi-process runs: ``coordinator`` (``host:port`` of process 0),
``num_processes`` and ``process_id`` bring up the process group first
(``parallel.distributed.initialize``; torch's ``MASTER_ADDR``/
``MASTER_PORT``/``RANK``/``WORLD_SIZE`` as ``torchrun`` sets them do too),
and ``mesh`` (``"dp[,tp]"``) lands in ``root.common.mesh_shape``, where the
fused path's mesh adoption reads it.  ``compile_cache_dir`` (default:
``$ZNICZ_COMPILE_CACHE``) points the kernel builds at a directory later
runs share (:mod:`znicz_tpu_torch.compilecache`), before anything
builds."""

from __future__ import annotations

import contextlib
import importlib
import importlib.util
import inspect
import os
import runpy

from . import backends, prng
from .config import apply_overrides, root
from .parallel.mesh import parse_mesh_arg
from .telemetry import profiler


def load_workflow_module(spec: str):
    """Import a workflow module from a file path or dotted module name."""
    if spec.endswith(".py") or os.path.sep in spec:
        name = os.path.splitext(os.path.basename(spec))[0]
        mod_spec = importlib.util.spec_from_file_location(name, spec)
        if mod_spec is None:
            raise ImportError(f"cannot load workflow file {spec!r}")
        module = importlib.util.module_from_spec(mod_spec)
        mod_spec.loader.exec_module(module)
        return module
    return importlib.import_module(spec)


def exec_config_file(path: str) -> None:
    """Run a config file: plain Python mutating the global ``root``."""
    runpy.run_path(path, init_globals={"root": root})


class Launcher:
    """Builds and runs one workflow according to CLI-ish options."""

    def __init__(self, workflow: str, config: str | None = None,
                 device="auto", snapshot: str | None = None,
                 epochs: int | None = None, fused: bool = False,
                 seed: int | None = None, overrides=(),
                 coordinator: str | None = None, num_processes: int = 1,
                 process_id: int = 0, profile: str | None = None,
                 timeline_jsonl: str | None = None,
                 mesh: str | None = None,
                 compile_cache_dir: str | None = None):
        if mesh is not None:
            parse_mesh_arg(mesh)          # junk fails before any work
        self.workflow_spec = workflow
        self.config_path = config
        self.device = device
        self.snapshot = snapshot
        self.epochs = epochs
        self.fused = fused
        self.seed = seed
        self.overrides = list(overrides)
        self.profile = profile
        self.timeline_jsonl = timeline_jsonl
        self.coordinator = coordinator
        self.num_processes = num_processes
        self.process_id = process_id
        self.mesh = mesh
        self.compile_cache_dir = compile_cache_dir
        self.workflow = None
        self.module = None

    @contextlib.contextmanager
    def _timeline_env(self):
        """``timeline_jsonl`` scoped to THIS run: the environment variable
        is the channel ``StandardWorkflow.train`` defaults from (the
        samples' ``run()`` signatures stay as they are), and it must not
        outlive the run, or a later in-process run without it would append
        its epochs to this run's file."""
        if not self.timeline_jsonl:
            yield
            return
        prev = os.environ.get("ZNICZ_TIMELINE_JSONL")
        os.environ["ZNICZ_TIMELINE_JSONL"] = self.timeline_jsonl
        try:
            yield
        finally:
            if prev is None:
                os.environ.pop("ZNICZ_TIMELINE_JSONL", None)
            else:
                os.environ["ZNICZ_TIMELINE_JSONL"] = prev

    def _trace_ctx(self, device: backends.Device):
        """A ``torch.profiler`` trace of the whole run into ``profile``
        (CPU and CUDA activity on the card, CPU only on the CPU and the
        numpy device)."""
        return profiler.trace(self.profile, device.torch_device)

    def init_distributed(self) -> None:
        """The process group of a multi-process run (a no-op for one
        process without a rendezvous), on the run's device."""
        from .parallel import distributed
        asked = (self.coordinator is not None or self.num_processes != 1
                 or self.process_id != 0)
        if not asked and not distributed.env_rendezvous():
            return
        device = backends.get(self.device)
        distributed.initialize(
            self.coordinator, self.num_processes if asked else None,
            self.process_id if asked else None,
            device=device.torch_device if device.is_torch else "cpu")

    def build(self):
        """Process group, config file, module import, ``--set`` overrides,
        ``--mesh``, seed; returns the module.  Overrides come last: they
        must win over both, and deep paths resolve only once the module's
        defaults exist."""
        self.init_distributed()
        # the kernel-build cache must be live before any kernel of the
        # run builds (env default: $ZNICZ_COMPILE_CACHE)
        from . import compilecache
        compilecache.enable(self.compile_cache_dir)
        if self.config_path:
            exec_config_file(self.config_path)
        module = load_workflow_module(self.workflow_spec)
        self.module = module
        apply_overrides(self.overrides)
        if self.mesh is not None:
            # --mesh lands in the config tree, where run_fused's mesh
            # adoption defaults from; it wins over config files as --set
            root.common.mesh_shape = parse_mesh_arg(self.mesh)
        prng.seed_all(self.seed if self.seed is not None
                      else root.common.get("seed", 1234))
        if not hasattr(module, "run"):
            raise AttributeError(
                f"workflow module {self.workflow_spec!r} defines no "
                "run() entry point")
        return module

    def run(self):
        """Execute end to end; returns the finished workflow."""
        with self._timeline_env():
            return self._run()

    def _run(self):
        module = self.build()
        device = backends.get(self.device)
        if self.snapshot:
            # resume: build and initialize without training, load the
            # snapshot, then train on from its epoch
            from .snapshotter import SnapshotterToFile
            wf = self._build_workflow_only(module, device)
            SnapshotterToFile.load(wf, self.snapshot)
            if self.epochs is not None:
                wf.decision.max_epochs = self.epochs
            with self._trace_ctx(device):
                if hasattr(wf, "train"):
                    wf.train(fused=self.fused)
                else:
                    wf.run()
            self.workflow = wf
            return wf
        sig = inspect.signature(module.run).parameters
        kwargs = {"device": device, "fused": self.fused}
        if self.epochs is not None:
            kwargs["epochs"] = self.epochs
        with self._trace_ctx(device):
            self.workflow = module.run(
                **{k: v for k, v in kwargs.items() if k in sig})
        return self.workflow

    def _build_workflow_only(self, module, device):
        """Construct and initialize the module's workflow class without
        training it (the resume path loads state in between): an explicit
        ``WORKFLOW`` attribute (class or zero-argument factory), else the
        module's one ``*Workflow`` class; several are an error."""
        target = getattr(module, "WORKFLOW", None)
        if target is None:
            found = [getattr(module, name) for name in dir(module)
                     if isinstance(getattr(module, name), type)
                     and name.endswith("Workflow")
                     and getattr(getattr(module, name), "__module__", "")
                     == module.__name__]
            if len(found) > 1:
                raise AttributeError(
                    f"workflow module {self.workflow_spec!r} defines "
                    f"{len(found)} *Workflow classes; set WORKFLOW = "
                    f"<class or factory> to pick the resume target")
            if not found:
                raise AttributeError(
                    f"workflow module {self.workflow_spec!r} has no "
                    "*Workflow class to resume into")
            target = found[0]
        wf = target()
        wf.initialize(device=device)
        return wf
