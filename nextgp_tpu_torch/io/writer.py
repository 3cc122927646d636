"""Asynchronous MCMC output spooling.

Copy of `nextgp_tpu.io.writer` (`folder_handler`, `truncate_outputs`,
`MCMCWriter`): one tab-delimited `<quantity>Out` file per tracked quantity
with a header row (NextGP.jl's `IO.outMCMC`, outFiles.jl:17-21), in an
output folder wiped on start (folderHandler, misc.jl:221-232). The chain
loop puts host arrays on a queue; a writer thread buffers rows per
quantity and appends them in blocks, so the sweeps never wait on the
filesystem. Rows take the JAX package's pure-Python form (`repr` of each
float, `str` of each integer: both round-trip exactly); the native spooler
is not ported.
"""
from __future__ import annotations

import os
import queue
import shutil
import threading
from typing import Dict, List, Optional

import numpy as np
import torch


def folder_handler(out_folder: str):
    """Delete-and-recreate the output folder (misc.jl:221-232)."""
    if os.path.isdir(out_folder):
        shutil.rmtree(out_folder)
    os.makedirs(out_folder, exist_ok=True)


def truncate_outputs(out_folder: str, kept_rows: int):
    """Truncate every `<name>Out` file to header + `kept_rows` data rows.

    Called on checkpoint resume: rows spooled after the last checkpoint
    survive a crash and would be re-emitted by the resumed loop, duplicating
    draws; truncating to the checkpointed row count makes resume exact for
    the output files too.
    """
    if not os.path.isdir(out_folder):
        return
    for fn in os.listdir(out_folder):
        if not fn.endswith("Out"):
            continue
        path = os.path.join(out_folder, fn)
        with open(path, "rb+") as fh:
            off = 0
            for _ in range(kept_rows + 1):  # +1 for the header row
                line = fh.readline()
                if not line:
                    off = None  # fewer rows than the checkpoint -> keep all
                    break
                off = fh.tell()
            if off is not None:
                fh.truncate(off)


class MCMCWriter:
    """Queue-backed writer: `put(sample_dict)` from the chain loop; a daemon
    thread buffers rows per quantity and appends them in blocks."""

    def __init__(
        self,
        out_folder: str,
        headers: Optional[Dict[str, List[str]]] = None,
        block_rows: int = 32,
    ):
        self.out_folder = out_folder
        os.makedirs(out_folder, exist_ok=True)
        self._headered: set = set()
        self._headers = headers or {}
        self._buf: Dict[str, List[np.ndarray]] = {}
        self._block_rows = block_rows
        self._q: "queue.Queue" = queue.Queue(maxsize=64)
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._err: Optional[BaseException] = None
        self._closed = False
        self._thread.start()

    def _path(self, name: str, width: int) -> str:
        path = os.path.join(self.out_folder, f"{name}Out")
        if name not in self._headered:
            if not os.path.exists(path) or os.path.getsize(path) == 0:
                hdr = self._headers.get(name) or [f"{name}{i + 1}" for i in range(width)]
                with open(path, "w") as fh:
                    fh.write("\t".join(str(h) for h in hdr) + "\n")
            self._headered.add(name)
        return path

    def _write_block(self, name: str, rows: List[np.ndarray]):
        block = np.stack([np.atleast_1d(r).reshape(-1) for r in rows])
        path = self._path(name, block.shape[1])
        # the JAX package's text (repr of each value as a Python float, str
        # of each integer), formatted from Python numbers: tolist() converts
        # a row at once, where a numpy scalar each cost more than its repr
        fmt = repr if block.dtype.kind == "f" else str
        with open(path, "a", buffering=1 << 20) as fh:
            for row in block.tolist():
                fh.write("\t".join(map(fmt, row)))
                fh.write("\n")

    def _drain_buffers(self):
        # pop before writing: a failed write must not leave rows behind to
        # be re-appended by a later drain (duplicate draws on disk)
        for name in list(self._buf):
            rows = self._buf.pop(name)
            if rows:
                self._write_block(name, rows)

    def _loop(self):
        while True:
            item = self._q.get()
            if item is None:
                try:
                    self._drain_buffers()
                except BaseException as e:
                    self._err = e
                return
            if isinstance(item, threading.Event):  # flush barrier
                try:
                    self._drain_buffers()
                except BaseException as e:
                    self._err = e
                item.set()
                continue
            for name, val in item.items():
                buf = self._buf.setdefault(name, [])
                buf.append(val)
                if len(buf) >= self._block_rows:
                    # detach the rows BEFORE writing: a partial write must
                    # not be retried (rows already on disk would be
                    # appended again, double-weighting those draws), and a
                    # failure on one quantity must not drop the others
                    rows, self._buf[name] = buf, []
                    try:
                        self._write_block(name, rows)
                    except BaseException as e:  # surfaced on close()
                        self._err = e

    def put(self, sample: Dict[str, np.ndarray]):
        """Queue one kept sample: {name: host array}. Tensors are refused:
        the caller copies them off the device, once for many samples where
        it can (a tensor here would cost one device-to-host copy each)."""
        for k, v in sample.items():
            if isinstance(v, torch.Tensor):
                raise TypeError(f"MCMCWriter.put: {k!r} is a tensor; pass host (numpy) arrays")
        self._q.put({k: np.asarray(v) for k, v in sample.items()})

    def flush(self):
        """Drain queued samples and land them on disk (checkpoint consistency).
        No-op after close() (the writer thread is gone; waiting on a barrier
        it will never set would deadlock the caller)."""
        if self._closed:
            return
        barrier = threading.Event()
        self._q.put(barrier)
        barrier.wait()

    def close(self):
        if self._closed:
            return
        self._closed = True
        self._q.put(None)
        self._thread.join()
        if self._err is not None:
            raise self._err
