"""Windowed meters, step logging and TensorBoard.

Counterpart of ``youku_mplug_tpu/train/metrics.py``: ``SmoothedValue``
(a window's median, mean and max beside the running mean),
``MetricLogger`` (named meters and ``log_every``) and
``TensorboardLogger``, which is off when ``tensorboardX`` is not
installed, as there.  One process: no meter is synchronized."""

from __future__ import annotations

import datetime
import time
from collections import defaultdict, deque
from typing import Optional


class SmoothedValue:
    def __init__(self, window_size: int = 20, fmt: str = "{median:.4f} "
                                                         "({global_avg:.4f})"):
        self.deque = deque(maxlen=window_size)
        self.total = 0.0
        self.count = 0
        self.fmt = fmt

    def update(self, value, n: int = 1):
        self.deque.append(float(value))
        self.count += n
        self.total += float(value) * n

    @property
    def median(self):
        d = sorted(self.deque)
        return d[len(d) // 2] if d else 0.0

    @property
    def avg(self):
        return sum(self.deque) / max(len(self.deque), 1)

    @property
    def global_avg(self):
        return self.total / max(self.count, 1)

    @property
    def max(self):
        return max(self.deque) if self.deque else 0.0

    @property
    def value(self):
        return self.deque[-1] if self.deque else 0.0

    def __str__(self):
        return self.fmt.format(median=self.median, avg=self.avg,
                               global_avg=self.global_avg, max=self.max,
                               value=self.value)


class MetricLogger:
    def __init__(self, delimiter: str = "  "):
        self.meters = defaultdict(SmoothedValue)
        self.delimiter = delimiter

    def update(self, **kwargs):
        for k, v in kwargs.items():
            self.meters[k].update(float(v))

    def __getattr__(self, attr):
        if attr in self.meters:
            return self.meters[attr]
        raise AttributeError(attr)

    def __str__(self):
        return self.delimiter.join(
            f"{name}: {meter}" for name, meter in self.meters.items())

    def log_every(self, iterable, print_freq: int, header: str = "",
                  total: Optional[int] = None):
        total = total if total is not None else (
            len(iterable) if hasattr(iterable, "__len__") else None)
        i = 0
        start = time.time()
        end = time.time()
        iter_time = SmoothedValue(fmt="{avg:.4f}")
        data_time = SmoothedValue(fmt="{avg:.4f}")
        for obj in iterable:
            data_time.update(time.time() - end)
            yield obj
            iter_time.update(time.time() - end)
            if i % print_freq == 0 or (total and i == total - 1):
                eta = ""
                if total:
                    eta_s = iter_time.global_avg * (total - i)
                    eta = f"eta: {datetime.timedelta(seconds=int(eta_s))}  "
                print(f"{header} [{i}{'/' + str(total) if total else ''}]  "
                      f"{eta}{self}  time: {iter_time}  data: {data_time}",
                      flush=True)
            i += 1
            end = time.time()
        elapsed = time.time() - start
        print(f"{header} Total time: "
              f"{datetime.timedelta(seconds=int(elapsed))}", flush=True)


class TensorboardLogger:
    """tensorboardX writer of scalars; off when ``enabled`` is False or
    tensorboardX is not installed."""

    def __init__(self, log_dir: str, enabled: bool = True):
        self.step = 0
        self.writer = None
        if enabled:
            try:
                from tensorboardX import SummaryWriter
            except ImportError:
                return
            self.writer = SummaryWriter(logdir=log_dir)

    def set_step(self, step: Optional[int] = None):
        self.step = step if step is not None else self.step + 1

    def update(self, head: str = "scalar", step: Optional[int] = None,
               **kwargs):
        if self.writer is None:
            return
        for k, v in kwargs.items():
            if v is None:
                continue
            self.writer.add_scalar(
                f"{head}/{k}", float(v),
                self.step if step is None else step)

    def flush(self):
        if self.writer is not None:
            self.writer.flush()
