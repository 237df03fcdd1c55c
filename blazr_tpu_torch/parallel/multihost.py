"""Multi-process bring-up.

Counterpart of ``blazr_tpu/parallel/multihost.py`` (:28-96). The JAX
package starts ``jax.distributed`` and runs one SPMD program over every
host's chips. The port runs one process per rank on
``torch.distributed.init_process_group``: ``init_distributed`` reads the same
``BLAZR_TPU_COORDINATOR`` / ``BLAZR_TPU_NUM_PROCESSES`` /
``BLAZR_TPU_PROCESS_ID`` and picks the backend by ``comm.choose_backend``
(NCCL where every rank has a card of its own, gloo otherwise; logged). Rank
r runs on ``cuda:{r % device_count}``, or on the CPU.

``launch_local`` is the one-command form (``cli run --tp 2``): the calling
process is rank 0 and starts ranks 1..N-1 on this host as copies of its own
command with ``--coordinator/--num-processes/--process-id`` added. A rank
started so ends itself when its parent is gone (``watch_parent``), so a
killed rank 0 leaves no rank waiting in a collective.

``serving_mesh`` builds a mesh's process groups once a process: a model
served by an Executor and a BatchEngine shares one mesh.

``RankPool`` keeps rank processes on this host that run jobs, each a
function over a fresh world of its own (the parallel tests on the CPU, and
the card's smoke run): ``python -m blazr_tpu_torch.parallel.multihost DIR
RANK DEVICE`` is one such process.
"""

from __future__ import annotations

import datetime
import importlib
import importlib.util
import logging
import os
import socket
import subprocess
import sys
import threading
import time
import traceback
from pathlib import Path
from typing import Any, Optional

import torch
import torch.distributed as dist

from .comm import choose_backend
from .mesh import MeshConfig, RankMesh, make_mesh

logger = logging.getLogger(__name__)

# A collective that waits longer than this fails instead of hanging.
TIMEOUT_S = 600.0
_meshes: dict[MeshConfig, RankMesh] = {}


def init_distributed(coordinator: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     device: str = "cuda",
                     timeout_s: float = TIMEOUT_S) -> bool:
    """Join the process group (idempotent). Falls back to the environment
    variables; returns True when a world of more than one process is up.
    ``coordinator`` is ``host:port`` (TCP) or an init URL (``file://...``)."""
    if dist.is_initialized():
        return dist.get_world_size() > 1
    coordinator = coordinator or os.environ.get("BLAZR_TPU_COORDINATOR")
    if num_processes is None and os.environ.get("BLAZR_TPU_NUM_PROCESSES"):
        num_processes = int(os.environ["BLAZR_TPU_NUM_PROCESSES"])
    if process_id is None and os.environ.get("BLAZR_TPU_PROCESS_ID"):
        process_id = int(os.environ["BLAZR_TPU_PROCESS_ID"])
    if coordinator is None and num_processes is None:
        return False
    if num_processes is not None and num_processes <= 1:
        return False
    if coordinator is None or num_processes is None or process_id is None:
        raise ValueError("a multi-process world needs --coordinator host:port, "
                         "--num-processes and --process-id")
    dev = torch.device(device)
    count = torch.cuda.device_count() if dev.type == "cuda" else 0
    if dev.type == "cuda" and count == 0:
        raise RuntimeError("no CUDA device for this rank; run the world with --device cpu")
    backend = choose_backend(dev.type, num_processes, count)
    if dev.type == "cuda":
        torch.cuda.set_device(process_id % count)
    url = coordinator if "://" in coordinator else f"tcp://{coordinator}"
    dist.init_process_group(backend, init_method=url,
                            world_size=num_processes, rank=process_id,
                            timeout=datetime.timedelta(seconds=timeout_s))
    logger.info("torch.distributed up: rank %d/%d over %s (%s, %d cards on this host)",
                process_id, num_processes, backend, dev.type, count)
    return True


def is_primary() -> bool:
    """True on the process that owns user-facing side effects (HTTP, output)."""
    return not dist.is_initialized() or dist.get_rank() == 0


def process_info() -> dict:
    up = dist.is_initialized()
    return {"process_index": dist.get_rank() if up else 0,
            "process_count": dist.get_world_size() if up else 1,
            "backend": dist.get_backend() if up else None,
            "local_devices": torch.cuda.device_count()}


def serving_mesh(cfg: MeshConfig, device: torch.device) -> RankMesh:
    """The process' mesh of ``cfg``, its groups built on first use."""
    mesh = _meshes.get(cfg)
    if mesh is None:
        mesh = _meshes[cfg] = make_mesh(cfg, device)
    return mesh


def shutdown() -> None:
    _meshes.clear()
    if dist.is_initialized():
        dist.destroy_process_group()


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch_local(argv: list[str], world: int) -> tuple[str, list[subprocess.Popen]]:
    """Start ranks 1..world-1 of this command on this host; returns the
    coordinator address for rank 0 (the caller) and the started processes.
    Their standard output is dropped (rank 0 answers), errors are kept."""
    coordinator = f"127.0.0.1:{free_port()}"
    procs = []
    for r in range(1, world):
        cmd = [sys.executable, "-m", "blazr_tpu_torch.cli", "--coordinator", coordinator,
               "--num-processes", str(world), "--process-id", str(r), *argv]
        procs.append(subprocess.Popen(cmd, stdout=subprocess.DEVNULL,
                                      env=dict(os.environ, BLAZR_TPU_PARENT=str(os.getpid()))))
    return coordinator, procs


def stop_ranks(procs: list[subprocess.Popen], timeout_s: float = 60.0) -> list[int]:
    """Wait for started ranks to end, killing any still alive at the
    deadline; their exit codes."""
    deadline = time.monotonic() + timeout_s
    codes = []
    for p in procs:
        try:
            codes.append(p.wait(timeout=max(0.1, deadline - time.monotonic())))
        except subprocess.TimeoutExpired:
            p.kill()
            codes.append(p.wait())
    return codes


def watch_parent() -> None:
    """In a rank started by ``launch_local``: end this process when the
    parent (rank 0) is gone, so no rank is left in a collective."""
    parent = os.environ.get("BLAZR_TPU_PARENT")
    if not parent:
        return
    pid = int(parent)

    def loop():
        while True:
            time.sleep(1.0)
            if os.getppid() != pid:
                os._exit(3)

    threading.Thread(target=loop, daemon=True, name="watch-parent").start()


class RankPool:
    """``n`` rank processes on this host. A job names a function
    (``"module:function"``, the module imported by each rank from its
    ``sys.path``, or ``"path/file.py:function"``) and a world size: ranks 0..world-1 each join a fresh world through a
    file store under ``root``, call the function on the job's arguments
    under ``torch.no_grad``, and hand back its result; the others sit it
    out. The processes start once (a rank takes seconds to reach a card). A
    job whose rank raises, exits or passes the deadline stops the pool and
    raises ``RuntimeError`` with every rank's error or log tail. ``env``
    is the ranks' environment (their ``PYTHONPATH``)."""

    def __init__(self, n: int, root: Path, device: str = "cpu",
                 env: Optional[dict] = None):
        self.root, self.n, self.i = Path(root), n, 0
        self.root.mkdir(parents=True, exist_ok=True)
        self.logs = [open(self.root / f"rank{r}.log", "w") for r in range(n)]
        self.procs = [subprocess.Popen(
            [sys.executable, "-m", "blazr_tpu_torch.parallel.multihost", str(self.root),
             str(r), device], env=env, stdout=self.logs[r], stderr=subprocess.STDOUT)
            for r in range(n)]

    def tail(self) -> str:
        return "\n".join(f"-- rank {r}\n" + (self.root / f"rank{r}.log").read_text()[-3000:]
                         for r in range(self.n))

    def _post(self, spec: dict) -> None:
        tmp = self.root / f"job-{self.i}.tmp"
        torch.save(spec, tmp)
        tmp.rename(self.root / f"job-{self.i}.pt")

    def run(self, fn: str, world: int, args: Any, timeout: float = 600.0) -> list:
        """Each of ranks 0..world-1's result of ``fn(args)``, in rank order."""
        i = self.i
        self._post({"fn": fn, "world": world, "args": args, "timeout": timeout})
        self.i += 1
        deadline = time.monotonic() + timeout
        out: dict = {}
        failed_at = None
        while len(out) < self.n:
            for r in range(self.n):
                f = self.root / f"res-{i}-{r}.pt"
                if r not in out and f.exists():
                    out[r] = torch.load(f, weights_only=False)
            errors = {r: o["error"] for r, o in out.items()
                      if isinstance(o, dict) and "error" in o}
            if errors:
                # One rank's failure ends its peers' collectives too: wait a
                # little for theirs, then report every rank's.
                failed_at = failed_at or time.monotonic()
                if len(out) == self.n or time.monotonic() - failed_at > 30:
                    self.close()
                    raise RuntimeError(f"{fn}: ranks {sorted(errors)} failed\n" + "\n".join(
                        f"-- rank {r}\n{e}" for r, e in sorted(errors.items())))
            if any(p.poll() is not None for p in self.procs):
                self.close()
                raise RuntimeError(f"{fn}: a rank exited\n{self.tail()}")
            if time.monotonic() > deadline:
                self.close()
                raise RuntimeError(f"{fn}: no result within {timeout:.0f} s\n{self.tail()}")
            time.sleep(0.05)
        return [out[r] for r in range(world)]

    def close(self) -> None:
        """Stop the ranks: a last job tells them to end; one that does not
        within a minute is killed."""
        if self.procs and all(p.poll() is None for p in self.procs):
            self._post({"fn": None})
        for p in self.procs:
            try:
                p.wait(60)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait(60)
        for f in self.logs:
            f.close()
        self.procs = []

    def __enter__(self) -> "RankPool":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def _module(target: str):
    """A module by name, or a ``.py`` file's, loaded once under its stem."""
    if not target.endswith(".py"):
        return importlib.import_module(target)
    path = Path(target)
    mod = sys.modules.get(path.stem)
    if mod is None:
        spec = importlib.util.spec_from_file_location(path.stem, path)
        mod = sys.modules[path.stem] = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    return mod


def _pool_rank(root: Path, rank: int, device: str) -> int:
    """A RankPool process: run each job in turn until the last."""
    i = 0
    while True:
        job = root / f"job-{i}.pt"
        while not job.exists():
            time.sleep(0.05)
        spec = torch.load(job, weights_only=False)
        if spec["fn"] is None:
            return 0
        out = None
        if rank < spec["world"]:
            try:
                target, name = spec["fn"].rsplit(":", 1)
                fn = getattr(_module(target), name)
                init_distributed(f"file://{root}/store-{i}", spec["world"], rank,
                                 device=device, timeout_s=spec["timeout"])
                with torch.no_grad():
                    out = fn(spec["args"])
            except BaseException:
                out = {"error": traceback.format_exc()}
            finally:
                shutdown()
        tmp = root / f"res-{i}-{rank}.tmp"
        torch.save(out, tmp)
        tmp.rename(root / f"res-{i}-{rank}.pt")
        i += 1


if __name__ == "__main__":
    # Through the package's module, whose mesh cache the engines use.
    from blazr_tpu_torch.parallel import multihost

    sys.exit(multihost._pool_rank(Path(sys.argv[1]), int(sys.argv[2]), sys.argv[3]))
