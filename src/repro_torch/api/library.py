"""Compiled interpolation libraries (twin of ``repro/api/library.py``).

``InterpLibrary`` packs the certified designs a model's numerics touch into
one padded ``(F, R_max, 3)`` int32 coefficient ROM (a torch tensor on the
serving device) plus a tuple of static :class:`FuncMeta` records. The fused
kernels take the ROM as one operand and read each function's rows at its
function id.

``save``/``load`` use the reference's npz + json manifest format, so a
library saved by either package loads in the other. The default library is
built from the vendored tables under ``api/tables/`` (byte copies of what
the reference generator writes), so serving needs no generator and no
download.

Manifest version 1 is the uniform layout (rows [0, 2^R) of a slot hold the
packed coefficients). Version 2 adds non-uniform segmentation: a segmented
slot stores S per-leaf coefficient rows followed by the segment-index table
packed 3 int32 entries per row, and the per-leaf datapath lives in
``FuncMeta.seg_meta``. A library with no segmented slot still saves as
version 1, byte for byte as before.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import pathlib
from typing import Sequence

import numpy as np
import torch

from repro_torch.core.funcspec import ACT_HI, ACT_KINDS, ACT_LO, act_out_span
from repro_torch.core.table import TableDesign
from repro_torch.device import resolve

DEFAULT_LIBRARY_KINDS = ("exp2neg", "gelu", "recip", "rsqrt", "sigmoid",
                         "silu", "softplus", "tanh")
# the vendored default tables: 12-bit inputs, R = 6, degree search from 0
TABLES_DIR = pathlib.Path(__file__).resolve().parent / "tables"
DEFAULT_TABLE_KEY = "12b_R6_d0"

_FORMAT_VERSION = 1
_FORMAT_VERSION_SEG = 2


class LibraryIntegrityError(RuntimeError):
    """The resident ROM no longer matches the checksum it was sealed with."""


@dataclasses.dataclass(frozen=True)
class FuncMeta:
    """Static per-function metadata of one library slot (hashable)."""

    kind: str
    name: str
    in_bits: int
    out_bits: int
    lookup_bits: int  # R: this function uses rows [0, 2^R) of its slot
    k: int
    degree: int
    sq_trunc: int
    lin_trunc: int
    act_lo: float = 0.0  # input window (direct activation tables only)
    act_hi: float = 0.0
    act_span: float = 0.0  # output span S: value = int * S / 2^out_bits
    # non-uniform segmentation (ROM v2; 0/() = uniform): seg_depth is the
    # segment-index table depth D, seg_meta one (eval_bits, k, sq_trunc,
    # lin_trunc, degree) row per leaf. For a segmented slot the scalar
    # k/degree/truncation fields record leaf 0's values and lookup_bits
    # records D, so a consumer that ignores seg_meta computes wrong numbers.
    seg_depth: int = 0
    seg_meta: tuple = ()

    @property
    def eval_bits(self) -> int:
        return self.in_bits - self.lookup_bits

    @property
    def segmented(self) -> bool:
        return self.seg_depth > 0

    @property
    def rows_used(self) -> int:
        """Slot rows this function occupies: 2^R uniform, else the per-leaf
        coefficient rows plus the packed segment-index table rows."""
        if not self.seg_depth:
            return 1 << self.lookup_bits
        return len(self.seg_meta) + ((1 << self.seg_depth) + 2) // 3

    def seg_spec(self) -> tuple | None:
        """The segment-datapath tuple (in_bits, depth, n_leaves, leaf_meta)
        of a segmented slot, None for a uniform one."""
        if not self.seg_depth:
            return None
        return (self.in_bits, self.seg_depth, len(self.seg_meta),
                self.seg_meta)

    def datapath_row(self) -> tuple[int, int, int, int, int]:
        """The (eval_bits, k, sq_trunc, lin_trunc, degree) kernel row."""
        return (self.eval_bits, self.k, self.sq_trunc, self.lin_trunc,
                self.degree)

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        if not self.seg_depth:  # keep uniform manifests byte-stable with v1
            d.pop("seg_depth")
            d.pop("seg_meta")
        else:
            d["seg_meta"] = [list(row) for row in self.seg_meta]
        return d


def _meta_from_dict(d: dict) -> FuncMeta:
    """A FuncMeta from a manifest entry (v1 entries carry no seg fields; v2
    seg_meta arrives as JSON lists and re-freezes to tuples, so the record
    stays hashable)."""
    d = dict(d)
    if "seg_meta" in d:
        d["seg_meta"] = tuple(tuple(int(v) for v in row)
                              for row in d["seg_meta"])
    return FuncMeta(**d)


def _check_datapath(m: FuncMeta) -> None:
    """The kernels shift by these amounts in 32-bit registers."""
    for row in (m.datapath_row(), *m.seg_meta):
        if not all(0 <= v < 32 for v in row[:4]):
            raise ValueError(f"{m.name}: datapath row {tuple(row)} has a "
                             f"shift outside [0, 32)")
    if m.seg_depth and not 0 < m.seg_depth < min(m.in_bits + 1, 32):
        raise ValueError(f"{m.name}: seg depth {m.seg_depth} outside "
                         f"[1, in_bits]")


def _sha(coeffs: np.ndarray) -> str:
    return hashlib.sha256(
        np.ascontiguousarray(coeffs, np.int32).tobytes()).hexdigest()[:16]


class InterpLibrary:
    """Every table a model's numerics touch, as one device ROM.

    Construct through :meth:`from_designs`, :meth:`default_library` or
    :meth:`load`.
    """

    def __init__(self, coeffs: torch.Tensor, metas: tuple[FuncMeta, ...]):
        self.coeffs = coeffs  # (F, R_max, 3) int32 on the serving device
        self.metas = tuple(metas)
        self._index = {m.kind: i for i, m in enumerate(self.metas)}
        self._meta_rows = None  # lazy (F, 5) int32 device tensor
        self._walk_table = None  # lazy ((F, 5), (L, 5)) host rows
        self._walk_rows = None  # ... and as int32 device tensors
        self._sealed_sha = None
        for m in self.metas:
            _check_datapath(m)

    # -- construction ------------------------------------------------------
    @classmethod
    def from_designs(cls, designs: Sequence,
                     kinds: Sequence[str],
                     act_windows: dict | None = None,
                     device: str | torch.device = "cuda") -> "InterpLibrary":
        """Pack verified designs into one padded ROM + static metadata.

        ``act_windows``: optional ``{kind: (lo, hi)}`` for activation tables
        generated over a non-default input window — recorded in the
        metadata and honored by the library-bound float glue. A
        :class:`repro_torch.segment.SegmentedDesign` fills a ROM-v2 slot
        (its ``packed_coeffs``: per-leaf rows, then the segment table)."""
        dev = resolve(device)
        if len(designs) != len(kinds) or not designs:
            raise ValueError("need one design per kind, at least one")
        dupes = {k for k in kinds if list(kinds).count(k) > 1}
        if dupes:
            raise ValueError(f"duplicate kinds in library: {sorted(dupes)}")
        metas = []
        for kind, d in zip(kinds, designs):
            seg_depth = getattr(d, "seg_depth", 0)
            if not seg_depth and d.degree != 2 and np.any(d.a != 0):
                raise ValueError(
                    f"{d.name}: degree-{d.degree} design with nonzero a")
            act = kind in ACT_KINDS
            lo, hi = (act_windows or {}).get(kind, (ACT_LO, ACT_HI))
            metas.append(FuncMeta(
                kind=kind, name=d.name, in_bits=d.in_bits,
                out_bits=d.out_bits, lookup_bits=d.lookup_bits, k=d.k,
                degree=d.degree, sq_trunc=d.sq_trunc, lin_trunc=d.lin_trunc,
                act_lo=lo if act else 0.0, act_hi=hi if act else 0.0,
                act_span=act_out_span(kind, lo, hi) if act else 0.0,
                seg_depth=seg_depth,
                seg_meta=tuple(getattr(d, "leaf_meta", ()))))
        r_max = max(m.rows_used for m in metas)
        packed = np.zeros((len(designs), r_max, 3), np.int32)
        for i, (m, d) in enumerate(zip(metas, designs)):
            packed[i, : m.rows_used] = d.packed_coeffs()
        return cls(torch.from_numpy(packed).to(dev), tuple(metas)).seal()

    @classmethod
    def default_library(cls, device: str | torch.device = "cuda"
                        ) -> "InterpLibrary":
        """The default manifest from the vendored tables (the reference's
        ``default_explorer().compile()``, without running the generator)."""
        designs = [
            TableDesign.from_dict(json.loads(
                (TABLES_DIR / f"{k}_{DEFAULT_TABLE_KEY}.json").read_text()))
            for k in DEFAULT_LIBRARY_KINDS]
        return cls.from_designs(designs, DEFAULT_LIBRARY_KINDS, device=device)

    # -- introspection -----------------------------------------------------
    @property
    def kinds(self) -> tuple[str, ...]:
        return tuple(m.kind for m in self.metas)

    @property
    def r_max(self) -> int:
        return int(self.coeffs.shape[1])

    @property
    def device(self) -> torch.device:
        return self.coeffs.device

    @property
    def segmented_kinds(self) -> tuple[str, ...]:
        return tuple(m.kind for m in self.metas if m.seg_depth)

    def __contains__(self, kind: str) -> bool:
        return kind in self._index

    def __len__(self) -> int:
        return len(self.metas)

    def __repr__(self) -> str:
        return (f"InterpLibrary({len(self.metas)} funcs, "
                f"coeffs{tuple(self.coeffs.shape)} on {self.device}: "
                f"{', '.join(self.kinds)})")

    def func_id(self, kind: str) -> int:
        try:
            return self._index[kind]
        except KeyError:
            raise KeyError(f"{kind!r} not in library {self.kinds}") from None

    def meta(self, kind: str) -> FuncMeta:
        return self.metas[self.func_id(kind)]

    def meta_rows(self) -> torch.Tensor:
        """(F, 5) int32 datapath rows on the ROM's device (kernel operand)."""
        if self._meta_rows is None:
            self._meta_rows = torch.tensor(
                [m.datapath_row() for m in self.metas], dtype=torch.int32,
                device=self.device)
        return self._meta_rows

    def walk_table(self) -> tuple[tuple[tuple[int, ...], ...],
                                  tuple[tuple[int, ...], ...]]:
        """The walk and leaf datapath rows of :meth:`walk_rows` on the host:
        the one place that lays out the leaf table (the kernels' slot rows
        read ``leaf_base`` and ``n_leaves`` from here)."""
        if self._walk_table is None:
            walk, dp = [], []
            for m in self.metas:
                base = len(dp)
                if m.seg_depth:
                    walk.append((m.in_bits, m.seg_depth, 1, base,
                                 len(m.seg_meta)))
                    dp.extend(m.seg_meta)
                else:
                    walk.append((m.in_bits, m.lookup_bits, 0, base, 1))
                    dp.append(m.datapath_row())
            self._walk_table = (tuple(walk), tuple(dp))
        return self._walk_table

    def walk_rows(self) -> tuple[torch.Tensor, torch.Tensor]:
        """Operands of the mixed uniform/segmented ROM walk, on the ROM's
        device: an ``(F, 5)`` int32 walk table of ``(in_bits, depth,
        seg_flag, leaf_base, n_leaves)`` rows (depth is R for a uniform
        slot, D for a segmented one) and an ``(L, 5)`` datapath table with
        one ``(eval_bits, k, sq_trunc, lin_trunc, degree)`` row per uniform
        function and one per segmented leaf (``leaf_base`` indexes it)."""
        if self._walk_rows is None:
            self._walk_rows = tuple(
                torch.tensor(rows, dtype=torch.int32, device=self.device)
                for rows in self.walk_table())
        return self._walk_rows

    # -- integrity ---------------------------------------------------------
    def rom_sha(self) -> str:
        """Checksum of the ROM bits resident right now (copies to host)."""
        return _sha(self.coeffs.cpu().numpy())

    def seal(self, sha: str | None = None) -> "InterpLibrary":
        self._sealed_sha = sha or self.rom_sha()
        return self

    @property
    def sealed_sha(self) -> str | None:
        return self._sealed_sha

    def verify_resident(self) -> str:
        """Re-checksum the resident ROM against the sealed baseline; raises
        :class:`LibraryIntegrityError` on mismatch."""
        sha = self.rom_sha()
        if self._sealed_sha is None:
            self._sealed_sha = sha
        elif sha != self._sealed_sha:
            raise LibraryIntegrityError(
                f"resident ROM checksum {sha} != sealed {self._sealed_sha}: "
                f"the in-memory coefficient ROM was corrupted after load")
        return sha

    def manifest(self) -> dict:
        f, r_max, _ = self.coeffs.shape
        version = (_FORMAT_VERSION_SEG if self.segmented_kinds
                   else _FORMAT_VERSION)
        return {"version": version, "kinds": list(self.kinds),
                "n_funcs": int(f), "r_max": int(r_max),
                "funcs": [m.to_dict() for m in self.metas]}

    # -- evaluation --------------------------------------------------------
    def eval_int(self, codes: torch.Tensor, kind: str) -> torch.Tensor:
        """Exact integer evaluation of one function on int32 codes, bit-
        identical to the design's ``eval_int``. CUDA tensors take
        :meth:`eval_fused`'s kernel; on the CPU a segmented slot takes the
        segment-index plain version ``interp_eval_seg_ref``, a uniform one
        ``library_eval``'s."""
        fid = self.func_id(kind)
        m = self.metas[fid]
        if m.seg_depth and not codes.is_cuda:
            from repro_torch.kernels.interp.ref import interp_eval_seg_ref

            return interp_eval_seg_ref(codes, self.coeffs[fid],
                                       seg=m.seg_spec())
        return self.eval_fused(codes, fid)

    def eval_fused(self, codes: torch.Tensor, fids) -> torch.Tensor:
        """Fused multi-function evaluation: element i reads table fids[i]
        (``fids`` may be one int for the whole tensor). An all-uniform
        library takes ``library_eval`` on its (F, 5) meta rows; any
        segmented slot switches the call to ``library_walk`` on the walk
        and per-leaf datapath rows, as the reference does."""
        if self.segmented_kinds:
            from repro_torch.kernels.interp.ops import library_walk

            walk, dp = self.walk_rows()
            return library_walk(codes, fids, self.coeffs, walk, dp)
        from repro_torch.kernels.interp.ops import library_eval

        return library_eval(codes, fids, self.coeffs, self.meta_rows())

    # -- persistence (npz coefficients + json manifest) --------------------
    def save(self, path: str | pathlib.Path) -> pathlib.Path:
        """Write ``<path>.<sha>.npz`` + the ``<path>.json`` manifest (the
        reference's layout, tmp-and-rename); returns the manifest path."""
        base = pathlib.Path(path)
        if base.suffix in (".json", ".npz"):
            base = base.with_suffix("")
        base.parent.mkdir(parents=True, exist_ok=True)
        coeffs = self.coeffs.cpu().numpy().astype(np.int32)
        sha = _sha(coeffs)
        npz_path = base.parent / f"{base.name}.{sha}.npz"
        tmp_npz = npz_path.with_suffix(".npz.tmp")
        try:
            with open(tmp_npz, "wb") as f:
                np.savez(f, coeffs=coeffs)
            tmp_npz.replace(npz_path)
        finally:
            tmp_npz.unlink(missing_ok=True)
        man = self.manifest()
        man["coeffs_file"] = npz_path.name
        man["coeffs_sha"] = sha
        tmp = base.with_suffix(".json.tmp")
        tmp.write_text(json.dumps(man, indent=1))
        tmp.replace(base.with_suffix(".json"))
        for stale in base.parent.glob(f"{base.name}.*.npz"):
            if stale.name != npz_path.name:
                stale.unlink(missing_ok=True)
        return base.with_suffix(".json")

    @classmethod
    def load(cls, path: str | pathlib.Path,
             device: str | torch.device = "cuda") -> "InterpLibrary":
        dev = resolve(device)
        base = pathlib.Path(path)
        if base.suffix in (".json", ".npz"):
            base = base.with_suffix("")
        man = json.loads(base.with_suffix(".json").read_text())
        if man.get("version") not in (_FORMAT_VERSION, _FORMAT_VERSION_SEG):
            raise ValueError(
                f"unsupported library version {man.get('version')}")
        with np.load(base.parent / man["coeffs_file"]) as z:
            coeffs = z["coeffs"].astype(np.int32)
        sha = _sha(coeffs)
        if man.get("coeffs_sha") and sha != man["coeffs_sha"]:
            raise ValueError(f"corrupt library ROM {base}.npz")
        metas = tuple(_meta_from_dict(f) for f in man["funcs"])
        return cls(torch.from_numpy(coeffs).to(dev), metas).seal(sha)


def load_library(path: str | pathlib.Path,
                 device: str | torch.device = "cuda") -> InterpLibrary:
    """Module-level convenience: :meth:`InterpLibrary.load`."""
    return InterpLibrary.load(path, device=device)
