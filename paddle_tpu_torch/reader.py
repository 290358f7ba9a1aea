"""paddle.reader — generator-combinator data pipeline (parity:
python/paddle/reader/decorator.py).  A "reader" is a zero-arg callable
returning an iterable of samples; these combinators compose them.  The
1.x-era API still ships in 2.x and plenty of dataset code uses it; the
modern path is ``paddle_tpu_torch.io.DataLoader`` (prefetch + multiprocess +
native datafeed), which these combinators feed cleanly.
"""
from __future__ import annotations

import itertools
import random as _random
from queue import Queue
from threading import Thread

__all__ = ["cache", "map_readers", "buffered", "compose", "chain",
           "shuffle", "firstn", "xmap_readers", "multiprocess_reader"]


def cache(reader):
    """Materialise once, replay from memory thereafter."""
    all_data = tuple(reader())

    def _impl():
        return iter(all_data)
    return _impl


def map_readers(func, *readers):
    """Zip readers, map ``func`` over the sample tuples."""
    def _impl():
        rs = [r() for r in readers]
        for vals in zip(*rs):
            yield func(*vals)
    return _impl


def shuffle(reader, buf_size):
    """Windowed shuffle with a ``buf_size`` reservoir."""
    def _impl():
        buf = []
        for e in reader():
            buf.append(e)
            if len(buf) >= buf_size:
                _random.shuffle(buf)
                yield from buf
                buf = []
        if buf:
            _random.shuffle(buf)
            yield from buf
    return _impl


def chain(*readers):
    """Concatenate readers back to back."""
    def _impl():
        return itertools.chain(*[r() for r in readers])
    return _impl


class ComposeNotAligned(ValueError):
    pass


def compose(*readers, **kwargs):
    """Zip readers into flat sample tuples; check_alignment raises
    ComposeNotAligned when one runs short."""
    check_alignment = kwargs.pop("check_alignment", True)

    def _flatten(x):
        if isinstance(x, tuple):
            return x
        return (x,)

    def _impl():
        rs = [r() for r in readers]
        if not check_alignment:
            for outputs in zip(*rs):
                yield sum((_flatten(o) for o in outputs), ())
            return
        for outputs in itertools.zip_longest(*rs):
            if any(o is None for o in outputs):
                raise ComposeNotAligned(
                    "outputs of readers are not aligned")
            yield sum((_flatten(o) for o in outputs), ())
    return _impl


def buffered(reader, size):
    """Decouple producer/consumer with a ``size``-deep thread queue."""
    end = object()

    def _impl():
        q: Queue = Queue(maxsize=size)

        def produce():
            try:
                for d in reader():
                    q.put(d)
            finally:
                q.put(end)

        t = Thread(target=produce, daemon=True)
        t.start()
        while True:
            e = q.get()
            if e is end:
                return
            yield e
    return _impl


def firstn(reader, n):
    def _impl():
        return itertools.islice(reader(), n)
    return _impl


def xmap_readers(mapper, reader, process_num, buffer_size, order=False):
    """Parallel map over a reader with ``process_num`` worker threads.
    ``order=True`` preserves input order."""
    end = object()

    def _impl():
        in_q: Queue = Queue(buffer_size)
        out_q: Queue = Queue(buffer_size)

        def feed():
            for i, d in enumerate(reader()):
                in_q.put((i, d))
            for _ in range(process_num):
                in_q.put(end)

        def work():
            while True:
                item = in_q.get()
                if item is end:
                    out_q.put(end)
                    return
                i, d = item
                out_q.put((i, mapper(d)))

        Thread(target=feed, daemon=True).start()
        for _ in range(process_num):
            Thread(target=work, daemon=True).start()

        finished = 0
        if not order:
            while finished < process_num:
                item = out_q.get()
                if item is end:
                    finished += 1
                    continue
                yield item[1]
            return
        want = 0
        hold = {}
        while finished < process_num or hold:
            if want in hold:
                yield hold.pop(want)
                want += 1
                continue
            if finished == process_num:
                break
            item = out_q.get()
            if item is end:
                finished += 1
                continue
            hold[item[0]] = item[1]
        while want in hold:                      # drain the tail
            yield hold.pop(want)
            want += 1
    return _impl


def multiprocess_reader(readers, use_pipe=True, queue_size=1000):
    """Merge readers each running in its own thread (the reference forks
    processes; the heavy parse/batch tier here is the GIL-free native
    datafeed, so threads suffice for the combinator role)."""
    end = object()

    def _impl():
        q: Queue = Queue(queue_size)

        def run(r):
            try:
                for d in r():
                    q.put(d)
            finally:
                q.put(end)

        for r in readers:
            Thread(target=run, args=(r,), daemon=True).start()
        finished = 0
        while finished < len(readers):
            e = q.get()
            if e is end:
                finished += 1
                continue
            yield e
    return _impl


def batch(reader, batch_size, drop_last=False):
    """paddle.batch (reference python/paddle/batch.py): group samples
    into lists of ``batch_size``."""
    def batch_reader():
        b = []
        for d in reader():
            b.append(d)
            if len(b) == batch_size:
                yield b
                b = []
        if b and not drop_last:
            yield b

    if batch_size <= 0:
        raise ValueError("batch_size should be a positive integer")
    return batch_reader
