"""TensorBoard scalar logging — self-contained tfevents writer (copied
from ``multimodal_auv_tpu/utils/tb.py``; the port imports nothing of that
package).

The reference instantiates torch.utils.tensorboard.SummaryWriter in every
pipeline (its functions.py:128-130) and logs per-batch/per-epoch scalars.
Same schema here, but the event files are written by a from-scratch
encoder — TFRecord framing (length + masked CRC32C) around hand-encoded
``Event`` protos — so the logging path needs no tensorboard package, and
any stock TensorBoard reads the output. A ``scalars.csv`` mirror is kept
alongside for grep-ability.
"""
from __future__ import annotations

import csv
import os
import socket
import struct
import time

# ---------------------------------------------------------------------------
# CRC32C (Castagnoli, reflected poly 0x82F63B78) — TFRecord checksums
# ---------------------------------------------------------------------------

def _make_crc_table():
    table = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ 0x82F63B78 if c & 1 else c >> 1
        table.append(c)
    return table


_CRC_TABLE = _make_crc_table()


def _crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for b in data:
        crc = _CRC_TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    """TFRecord's masked checksum: rotate right 15 + magic offset."""
    crc = _crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


# ---------------------------------------------------------------------------
# Minimal protobuf wire encoding for tensorboard.Event scalars
# ---------------------------------------------------------------------------

def _varint(n: int) -> bytes:
    if n < 0:  # int64 two's complement (protobuf encodes as 10-byte varint)
        n &= (1 << 64) - 1
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _key(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


def _len_delim(field: int, payload: bytes) -> bytes:
    return _key(field, 2) + _varint(len(payload)) + payload


def _scalar_event(tag: str, value: float, step: int, wall_time: float) -> bytes:
    # Summary.Value { string tag = 1; float simple_value = 2; }
    val = _len_delim(1, tag.encode()) + _key(2, 5) + struct.pack("<f", value)
    # Summary { repeated Value value = 1; }
    summary = _len_delim(1, val)
    # Event { double wall_time = 1; int64 step = 2; Summary summary = 5; }
    return (_key(1, 1) + struct.pack("<d", wall_time) +
            _key(2, 0) + _varint(int(step)) +
            _len_delim(5, summary))


def _version_event(wall_time: float) -> bytes:
    # Event { double wall_time = 1; string file_version = 3; }
    return (_key(1, 1) + struct.pack("<d", wall_time) +
            _len_delim(3, b"brain.Event:2"))


def _record(data: bytes) -> bytes:
    """TFRecord framing: u64 length, masked crc of the length bytes,
    payload, masked crc of the payload."""
    header = struct.pack("<Q", len(data))
    return (header + struct.pack("<I", _masked_crc(header)) +
            data + struct.pack("<I", _masked_crc(data)))


class SummaryWriter:
    """Scalar-only analogue of torch.utils.tensorboard.SummaryWriter."""

    def __init__(self, log_dir: str):
        self.log_dir = log_dir
        os.makedirs(log_dir, exist_ok=True)
        now = time.time()
        host = socket.gethostname() or "host"
        self._event_path = os.path.join(
            log_dir, f"events.out.tfevents.{int(now)}.{host}")
        self._csv_path = os.path.join(log_dir, "scalars.csv")
        # handles stay open (per-batch logging would otherwise pay two
        # open/close syscall pairs per scalar — costly on networked
        # filesystems); every write is flushed through, so a crash loses
        # at most OS-buffered bytes, same as the torch writer
        self._event_f = open(self._event_path, "ab")
        self._event_f.write(_record(_version_event(now)))
        self._event_f.flush()
        new_csv = not os.path.exists(self._csv_path)
        self._csv_f = open(self._csv_path, "a", newline="")
        if new_csv:
            csv.writer(self._csv_f).writerow(
                ["wall_time", "tag", "step", "value"])
            self._csv_f.flush()

    def add_scalar(self, tag: str, value, step: int):
        if self._event_f.closed:  # reopened after close(): append
            self._event_f = open(self._event_path, "ab")
            self._csv_f = open(self._csv_path, "a", newline="")
        value = float(value)
        now = time.time()
        self._event_f.write(_record(_scalar_event(tag, value, int(step), now)))
        self._event_f.flush()
        csv.writer(self._csv_f).writerow([now, tag, step, value])
        self._csv_f.flush()

    def flush(self):
        if not self._event_f.closed:
            self._event_f.flush()
            self._csv_f.flush()

    def close(self):
        if not self._event_f.closed:
            self._event_f.close()
            self._csv_f.close()


class NullSummaryWriter:
    """API-compatible no-op writer, for runs that keep no event stream."""

    log_dir = None

    def add_scalar(self, tag: str, value, step: int) -> None:
        pass

    def flush(self) -> None:
        pass

    def close(self) -> None:
        pass
