"""Minimal protobuf wire-format codec (no codegen, no proto files).

Counterpart of ``k8s_gpu_hpa_tpu/utils/protowire.py``, the same codec.  The
exporter's one gRPC peer is the kubelet PodResources API (GPU→pod
attribution, the socket dcgm-exporter mounts at dcgm-exporter.yaml:50-52,
57-59).  Rather than vendoring generated *_pb2.py stubs, it decodes the wire
format directly: protobuf's encoding is a flat list of (field_number,
wire_type, value) records, and unknown fields skip naturally — exactly the
forward-compatibility a kubelet client needs across versions.  The
``encode_*`` half builds kubelet responses for tests and ``chip_smoke.py``.

Supports the four live wire types: varint (0), fixed64 (1), length-delimited
(2), fixed32 (5).
"""

from __future__ import annotations

import struct

VARINT = 0
FIXED64 = 1
BYTES = 2
FIXED32 = 5


def _read_varint(data: bytes, pos: int) -> tuple[int, int]:
    result = 0
    shift = 0
    while True:
        if pos >= len(data):
            raise ValueError("truncated varint")
        byte = data[pos]
        pos += 1
        result |= (byte & 0x7F) << shift
        if not byte & 0x80:
            return result, pos
        shift += 7
        if shift > 63:
            raise ValueError("varint too long")


def encode_varint(value: int) -> bytes:
    if value < 0:
        # Negative int64s need 10-byte two's-complement or zigzag encoding;
        # no current caller produces them, so reject rather than loop forever
        # under Python's arithmetic right shift.
        raise ValueError("encode_varint requires a non-negative value")
    out = bytearray()
    while True:
        bits = value & 0x7F
        value >>= 7
        if value:
            out.append(bits | 0x80)
        else:
            out.append(bits)
            return bytes(out)


def encode_tag(field: int, wire_type: int) -> bytes:
    return encode_varint((field << 3) | wire_type)


def encode_string(field: int, value: str | bytes) -> bytes:
    raw = value.encode() if isinstance(value, str) else value
    return encode_tag(field, BYTES) + encode_varint(len(raw)) + raw


def encode_uint(field: int, value: int) -> bytes:
    """Encode a non-negative int as a varint field."""
    return encode_tag(field, VARINT) + encode_varint(value)


def encode_double(field: int, value: float) -> bytes:
    """Encode a float as a fixed64 IEEE-double field."""
    return encode_tag(field, FIXED64) + struct.pack("<d", value)


def decode_fields(data: bytes) -> list[tuple[int, int, int | bytes]]:
    """Decode a message into (field_number, wire_type, value) records.
    Varint/fixed values come back as ints, length-delimited as bytes."""
    out: list[tuple[int, int, int | bytes]] = []
    pos = 0
    while pos < len(data):
        tag, pos = _read_varint(data, pos)
        field, wire_type = tag >> 3, tag & 0x07
        if wire_type == VARINT:
            value, pos = _read_varint(data, pos)
        elif wire_type == FIXED64:
            if pos + 8 > len(data):
                raise ValueError("truncated fixed64")
            value = struct.unpack_from("<Q", data, pos)[0]
            pos += 8
        elif wire_type == BYTES:
            length, pos = _read_varint(data, pos)
            if pos + length > len(data):
                raise ValueError("truncated bytes field")
            value = data[pos : pos + length]
            pos += length
        elif wire_type == FIXED32:
            if pos + 4 > len(data):
                raise ValueError("truncated fixed32")
            value = struct.unpack_from("<I", data, pos)[0]
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wire_type}")
        out.append((field, wire_type, value))
    return out


def fields_by_number(data: bytes) -> dict[int, list[int | bytes]]:
    """Group decoded values by field number (repeated fields keep order)."""
    grouped: dict[int, list[int | bytes]] = {}
    for field, _, value in decode_fields(data):
        grouped.setdefault(field, []).append(value)
    return grouped


def as_double(value: int) -> float:
    """Reinterpret a fixed64 payload as an IEEE double."""
    return struct.unpack("<d", struct.pack("<Q", value))[0]


def as_sint(value: int) -> int:
    """Decode a zigzag-encoded signed varint payload."""
    return (value >> 1) ^ -(value & 1)
