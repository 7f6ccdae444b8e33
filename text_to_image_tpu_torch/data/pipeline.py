"""Host data tier (counterpart of ``text_to_image_tpu/data/pipeline.py``):
one worker thread assembles each tick's ``[batches_per_step, B, …]`` batch
with the dataset's numpy ``next_batch`` while the device computes, and, for
a CUDA device, copies it into pinned memory and on to the card with
``non_blocking=True`` on a side stream; ``prefetch`` batches are kept in
flight.  The consumer's stream waits for each copy before it uses the
batch.  With one worker the stream of batches is the dataset's own,
deterministic in its seed (the JAX pipeline's extra workers, each on a
spawned RNG, give a nondeterministic order, and are not ported).

Data parallel: every rank assembles the same global batch from the
dataset's seed and copies only its `rows` to its card (the JAX package's
``shard_batch`` of the host batch).
"""

from __future__ import annotations

import queue
import threading
from typing import Dict, Optional

import numpy as np
import torch


class InputPipeline:
    def __init__(self, dataset, batch_size: int, device="cuda",
                 window: int = 4, batches_per_step: int = 1,
                 prefetch: int = 2, rows: Optional[slice] = None):
        self.dataset = dataset
        self.rows = rows
        self.batch_size = batch_size
        self.window = window
        self.batches_per_step = batches_per_step
        self.device = torch.device(device)
        self._cuda = self.device.type == "cuda"
        self._stream = torch.cuda.Stream(self.device) if self._cuda else None
        self._q: queue.Queue = queue.Queue(maxsize=max(1, prefetch))
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _make_step_batch(self) -> Dict[str, np.ndarray]:
        batches = [self.dataset.next_batch(self.batch_size, self.window)
                   for _ in range(self.batches_per_step)]
        out = {k: np.stack([b[k] for b in batches]) for k in batches[0]}
        if self.rows is not None:
            out = {k: np.ascontiguousarray(v[:, self.rows])
                   for k, v in out.items()}
        return out

    def _to_device(self, batch: Dict[str, np.ndarray]):
        """(tensors on the device, the copy's event or None)."""
        host = {k: torch.from_numpy(v) for k, v in batch.items()}
        if not self._cuda:
            return host, None
        with torch.cuda.stream(self._stream):
            out = {k: v.pin_memory().to(self.device, non_blocking=True)
                   for k, v in host.items()}
            done = torch.cuda.Event()
            done.record(self._stream)
        return out, done

    def _worker(self):
        try:
            while not self._stop.is_set():
                item = self._to_device(self._make_step_batch())
                while not self._stop.is_set():
                    try:
                        self._q.put(item, timeout=0.1)
                        break
                    except queue.Full:
                        continue
        except Exception as e:   # handed to the consumer, which raises
            self._q.put((None, e))

    def __iter__(self):
        return self

    def __next__(self) -> Dict[str, torch.Tensor]:
        batch, done = self._q.get()
        if batch is None:
            raise RuntimeError("the input pipeline's worker failed") from done
        if done is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(done)
            for v in batch.values():   # allocated on the side stream
                v.record_stream(stream)
        return batch

    def close(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=2.0)
