"""First-party GRIB2 reader (numpy and ``struct`` only).

A copy of ``dlwp_cs_tpu.data.grib2``; it needs no compiled dependency.
It reads the subset of GRIB2 that NOAA CFS / GFS products use, so
:mod:`dlwp_cs_tpu_torch.data.cfsr` can open raw ``.grb2`` downloads:

* grid definition template 3.0 (regular latitude-longitude);
* data representation templates 5.0 (simple packing), 5.2 (complex
  packing), 5.3 (complex packing with 1st/2nd-order spatial differencing)
  and 5.40 (JPEG2000, decoded via Pillow's OpenJPEG binding, imported
  when such a field is decoded: without Pillow that template raises);
  other templates (e.g. IEEE floats) are rejected with a clear error;
* section 6 bitmaps (missing cells decode to NaN);
* product identity (discipline/category/number + fixed surface) and the
  reference time from section 1.
"""

from __future__ import annotations

import dataclasses
import datetime
import struct
from pathlib import Path

import numpy as np

__all__ = ["Grib2Record", "read_grib2", "scan_messages"]


@dataclasses.dataclass
class Grib2Record:
    """One decoded GRIB2 field."""

    discipline: int
    category: int
    number: int
    surface_type: int
    surface_value: float
    ref_time_days: float  # days since 2000-01-01 00 UTC
    lats: np.ndarray  # (ny,) radians, as stored (typically descending)
    lons: np.ndarray  # (nx,) radians
    values: np.ndarray  # (ny, nx) float64, NaN where bitmap masks

    @property
    def param(self) -> tuple[int, int, int]:
        return (self.discipline, self.category, self.number)


def _u(b: bytes, offset: int, size: int) -> int:
    return int.from_bytes(b[offset : offset + size], "big")


def _s(b: bytes, offset: int, size: int) -> int:
    """GRIB2 signed integer: sign-magnitude with the top bit as sign."""
    raw = _u(b, offset, size)
    sign_bit = 1 << (8 * size - 1)
    return -(raw & ~sign_bit) if raw & sign_bit else raw


def _bits(data: bytes, bit_offset: int, nbits: int, count: int) -> np.ndarray:
    """Read ``count`` big-endian unsigned ints of ``nbits`` bits each."""
    if nbits == 0:
        return np.zeros(count, np.int64)
    arr = np.frombuffer(data, np.uint8)
    allbits = np.unpackbits(arr)
    lo = bit_offset
    hi = lo + nbits * count
    if hi > allbits.size:
        raise ValueError("GRIB2 data section truncated")
    chunk = allbits[lo:hi].reshape(count, nbits).astype(np.int64)
    weights = (1 << np.arange(nbits - 1, -1, -1)).astype(np.int64)
    return chunk @ weights


def scan_messages(path):
    """Yield (offset, length, raw_bytes) for each GRIB2 message in a file."""
    raw = Path(path).read_bytes()
    pos = 0
    while True:
        idx = raw.find(b"GRIB", pos)
        if idx < 0:
            return
        if len(raw) < idx + 16:
            return
        edition = raw[idx + 7]
        if edition != 2:
            raise ValueError(f"GRIB edition {edition} unsupported (GRIB2 only)")
        total = _u(raw, idx + 8, 8)
        msg = raw[idx : idx + total]
        if msg[-4:] != b"7777":
            raise ValueError("corrupt GRIB2 message (missing 7777 trailer)")
        yield idx, total, msg
        pos = idx + total


def read_grib2(path, *, param=None) -> list[Grib2Record]:
    """Decode all (or parameter-filtered) fields of a GRIB2 file.

    ``param``: optional ``(discipline, category, number)`` filter.
    """
    out = []
    for _, _, msg in scan_messages(path):
        out.extend(_decode_message(msg, param))
    return out


def _decode_message(msg: bytes, param) -> list[Grib2Record]:
    discipline = msg[6]
    pos = 16
    ref_time = None
    grid = None
    prod = None
    rep = None
    bitmap = None
    records = []
    while pos < len(msg) - 4:
        if msg[pos : pos + 4] == b"7777":
            break
        seclen = _u(msg, pos, 4)
        if seclen < 5 or pos + seclen > len(msg):
            # a zeroed/garbage section length would otherwise stop the scan
            # from advancing (pos += 0 spins forever) or run off the message
            raise ValueError(
                f"corrupt GRIB2 section at offset {pos}: length {seclen}"
            )
        secnum = msg[pos + 4]
        body = msg[pos : pos + seclen]
        if secnum == 1:
            year = _u(body, 12, 2)
            month, day, hour, minute, sec = body[14], body[15], body[16], body[17], body[18]
            dt = datetime.datetime(year, month, day, hour, minute, sec)
            ref_time = (dt - datetime.datetime(2000, 1, 1)).total_seconds() / 86400.0
        elif secnum == 3:
            grid = _decode_grid(body)
        elif secnum == 4:
            prod = _decode_product(body)
        elif secnum == 5:
            rep = _decode_representation(body)
        elif secnum == 6:
            bitmap = _decode_bitmap(body, grid)
        elif secnum == 7:
            if grid is None or prod is None or rep is None:
                raise ValueError("GRIB2 data section before grid/product/rep")
            if param is None or param == (discipline, prod["category"], prod["number"]):
                vals = _decode_data(body, rep, grid, bitmap)
                records.append(
                    Grib2Record(
                        discipline=discipline,
                        category=prod["category"],
                        number=prod["number"],
                        surface_type=prod["surface_type"],
                        surface_value=prod["surface_value"],
                        ref_time_days=ref_time,
                        lats=grid["lats"],
                        lons=grid["lons"],
                        values=vals,
                    )
                )
        pos += seclen
    return records


def _decode_grid(body: bytes) -> dict:
    template = _u(body, 12, 2)
    if template != 0:
        raise ValueError(
            f"grid template 3.{template} unsupported (regular lat-lon only)"
        )
    # Basic angle (octets 39-46): 0/missing means the default 10^-6 degree
    # unit.  A nonzero basic angle rescales every coordinate — reject rather
    # than decode with the wrong unit.
    basic_angle = _u(body, 38, 4)
    subdiv = _u(body, 42, 4)
    if basic_angle not in (0, 0xFFFFFFFF) or subdiv not in (0, 0xFFFFFFFF):
        raise ValueError(
            "GRIB2 nonzero basic angle unsupported (non-10^-6-degree units)"
        )
    ni = _u(body, 30, 4)  # number of points along a parallel (lons)
    nj = _u(body, 34, 4)  # along a meridian (lats)
    lat1 = _s(body, 46, 4) * 1e-6
    lon1 = _u(body, 50, 4) * 1e-6
    lat2 = _s(body, 55, 4) * 1e-6
    lon2 = _u(body, 59, 4) * 1e-6
    # Scanning mode (octet 72): only the default row-major +i then -/+ j
    # layouts are supported; anything else (j-consecutive, boustrophedon,
    # negative-i) would silently garble values.reshape(nj, ni).
    scan = body[71]
    if scan & 0xBF != 0:  # any flag other than the j-direction bit (0x40)
        raise ValueError(
            f"GRIB2 scanning mode 0x{scan:02x} unsupported "
            "(only standard row-major i-scans)"
        )
    lats = np.deg2rad(np.linspace(lat1, lat2, nj))
    lon2u = lon2 if lon2 > lon1 else lon2 + 360.0
    lons = np.deg2rad(np.linspace(lon1, lon2u, ni))
    return {"ni": ni, "nj": nj, "lats": lats, "lons": lons}


def _decode_product(body: bytes) -> dict:
    template = _u(body, 7, 2)
    if template not in (0, 8):  # instant / statistically processed
        raise ValueError(f"product template 4.{template} unsupported")
    # First fixed surface: scale factor is SIGNED sign-magnitude (like the
    # section-5 E/D factors); 255 / all-ones means missing -> NaN, not a
    # plausible-looking 4294967295.0.
    scale = body[23]
    val = _u(body, 24, 4)
    if scale == 255 or val == 0xFFFFFFFF:
        surface_value = float("nan")
    else:
        if scale & 0x80:
            scale = -(scale & 0x7F)
        surface_value = val * (10.0 ** -scale)
    return {
        "category": body[9],
        "number": body[10],
        "surface_type": body[22],
        "surface_value": surface_value,
    }


def _decode_representation(body: bytes) -> dict:
    template = _u(body, 9, 2)
    npoints = _u(body, 5, 4)
    if template not in (0, 2, 3, 40):
        raise ValueError(
            f"data representation template 5.{template} unsupported "
            "(simple/complex/complex+differencing/JPEG2000 only — convert "
            "other products with wgrib2 first)"
        )
    (ref,) = struct.unpack(">f", body[11:15])
    rep = {
        "template": template,
        "npoints": npoints,
        "R": float(ref),
        "E": _s(body, 15, 2),
        "D": _s(body, 17, 2),
        "nbits": body[19],
    }
    if template in (2, 3):
        rep.update(
            group_split=body[21],
            missing_mgmt=body[22],
            ngroups=_u(body, 31, 4),
            group_width_ref=body[35],
            group_width_bits=body[36],
            group_len_ref=_u(body, 37, 4),
            group_len_inc=body[41],
            last_group_len=_u(body, 42, 4),
            group_len_bits=body[46],
        )
        if rep["missing_mgmt"] != 0:
            raise ValueError("GRIB2 missing-value management unsupported")
    if template == 3:
        rep.update(diff_order=body[47], diff_octets=body[48])
        if rep["diff_order"] not in (1, 2):
            raise ValueError(f"spatial differencing order {rep['diff_order']}")
    if template == 40:
        # octet 22: compression type (0 = lossless, 1 = lossy)
        rep.update(j2k_compression=body[21])
    return rep


def _decode_bitmap(body: bytes, grid) -> np.ndarray | None:
    indicator = body[5]
    if indicator == 255:
        return None
    if indicator != 0:
        raise ValueError(f"bitmap indicator {indicator} unsupported")
    n = grid["ni"] * grid["nj"]
    bits = np.unpackbits(np.frombuffer(body[6:], np.uint8))[:n]
    return bits.astype(bool)


def _decode_data(body: bytes, rep, grid, bitmap) -> np.ndarray:
    data = body[5:]
    n = grid["ni"] * grid["nj"]
    npacked = int(bitmap.sum()) if bitmap is not None else rep["npoints"]
    if rep["template"] == 0:
        x = _bits(data, 0, rep["nbits"], npacked).astype(np.float64)
    elif rep["template"] == 40:
        x = _unpack_jpeg2000(data, rep, npacked).astype(np.float64)
    else:
        x = _unpack_complex(data, rep, npacked).astype(np.float64)
    vals = (rep["R"] + x * (2.0 ** rep["E"])) / (10.0 ** rep["D"])
    if bitmap is not None:
        full = np.full(n, np.nan)
        full[bitmap] = vals
        vals = full
    return vals.reshape(grid["nj"], grid["ni"])


def _unpack_jpeg2000(data: bytes, rep, npacked: int) -> np.ndarray:
    """Template 5.40: the data section is a JPEG2000 codestream of X.

    Decoded with Pillow's OpenJPEG binding, imported here (without it this
    template raises); NCEP writes lossless (compression type 0) 5.40
    products, so the round-trip is exact.  A zero-bit field encodes a constant (X = 0).
    """
    if rep["nbits"] == 0:
        return np.zeros(npacked, np.int64)
    import io

    try:
        from PIL import Image
    except ImportError as e:
        raise ValueError(
            "GRIB2 template 5.40 (JPEG2000) needs Pillow with OpenJPEG"
        ) from e
    try:
        with Image.open(io.BytesIO(bytes(data))) as img:
            arr = np.asarray(img)
    except Exception as e:
        raise ValueError(f"GRIB2 JPEG2000 codestream decode failed: {e}") from e
    flat = arr.reshape(-1)
    if flat.size < npacked:
        raise ValueError(
            f"JPEG2000 field has {flat.size} samples, expected {npacked}"
        )
    return flat[:npacked].astype(np.int64)


def _unpack_complex(data: bytes, rep, npacked: int) -> np.ndarray:
    ng = rep["ngroups"]
    # Unpack the section's bits ONCE and slice per vector/group —
    # re-unpacking the whole buffer per group made decode O(NG * bytes)
    # (minutes for a real CFS field with thousands of groups).
    allbits = np.unpackbits(np.frombuffer(data, np.uint8))

    def take(bit_offset: int, nbits: int, count: int) -> np.ndarray:
        if nbits == 0:
            return np.zeros(count, np.int64)
        lo, hi = bit_offset, bit_offset + nbits * count
        if hi > allbits.size:
            raise ValueError("GRIB2 data section truncated")
        chunk = allbits[lo:hi].reshape(count, nbits).astype(np.int64)
        weights = (1 << np.arange(nbits - 1, -1, -1)).astype(np.int64)
        return chunk @ weights

    cursor = 0
    extras = []
    minsd = 0
    if rep["template"] == 3:
        w = rep["diff_octets"]
        order = rep["diff_order"]
        for _ in range(order):
            extras.append(_s(data, cursor // 8, w))
            cursor += 8 * w
        minsd = _s(data, cursor // 8, w)
        cursor += 8 * w
    refs = take(cursor, rep["nbits"], ng)
    cursor += rep["nbits"] * ng
    cursor = (cursor + 7) // 8 * 8  # octet-align after each vector
    widths = rep["group_width_ref"] + take(cursor, rep["group_width_bits"], ng)
    cursor += rep["group_width_bits"] * ng
    cursor = (cursor + 7) // 8 * 8
    lens = rep["group_len_ref"] + rep["group_len_inc"] * take(
        cursor, rep["group_len_bits"], ng
    )
    cursor += rep["group_len_bits"] * ng
    cursor = (cursor + 7) // 8 * 8
    lens = np.asarray(lens)
    if ng:
        lens[-1] = rep["last_group_len"]
    if int(lens.sum()) != npacked:
        raise ValueError(
            f"complex packing length mismatch: groups sum {int(lens.sum())} "
            f"vs {npacked} points"
        )
    out = np.empty(npacked, np.int64)
    pos = 0
    for g in range(ng):
        ln, wd = int(lens[g]), int(widths[g])
        vals = take(cursor, wd, ln) if wd else np.zeros(ln, np.int64)
        out[pos : pos + ln] = refs[g] + vals
        cursor += wd * ln
        pos += ln
    if rep["template"] == 3:
        out = out + minsd
        order = rep["diff_order"]
        # the first `order` values are stored verbatim in the extras
        if order == 2:
            # Undo x[i] = d[i] + 2 x[i-1] - x[i-2] in closed form: the first
            # differences f[i] = x[i] - x[i-1] satisfy f[i] = f[i-1] + d[i],
            # so two cumsum passes replace the per-point Python loop.
            x0 = int(extras[0])
            if npacked == 1:
                return np.array([x0], np.int64)
            x1 = int(extras[1])
            f = np.empty(npacked - 1, np.int64)
            f[0] = x1 - x0
            if npacked > 2:
                f[1:] = out[2:]
            f = np.cumsum(f)
            x = np.empty(npacked, np.int64)
            x[0] = x0
            x[1:] = x0 + np.cumsum(f)
            out = x
        else:
            out[:order] = extras
            out = np.cumsum(out)
    return out
