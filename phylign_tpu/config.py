"""Typed configuration mirroring the reference's config.yaml.

Key-for-key compatible with /root/reference/config.yaml:1-139 (the search
section affects results; the performance section does not), plus device
extensions (device batching, mesh shape). A reference config.yaml loads
unchanged; unknown keys error loudly so typos don't silently change runs.

The file format is the flat ``key: value`` subset of YAML that the
reference's config.yaml uses (scalars, quoted strings, booleans, null and
``#`` comments), read and written here without a YAML library.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import re
from dataclasses import dataclass
from pathlib import Path
from typing import Any

log = logging.getLogger("phylign_tpu.config")

# Keys accepted for reference-config compatibility that have no effect in
# this architecture (ref: /root/reference/config.yaml:89-125). Each maps to
# the one-line reason logged when a config sets it explicitly — silently
# ignoring them would imply the reference semantics apply.
INERT_KEYS = {
    "cobs_threads": "COBS query threading is replaced by the device kernel grid",
    "minimap_threads": "minimap2 threading is replaced by batched device alignment",
    "prefer_pipe": "there are no inter-process pipes in this architecture",
}


@dataclass
class Config:
    # --- search parameters (affect results; config.yaml:1-42) ---
    batches: str = "data/batches_full.txt"
    cobs_kmer_thres: float = 0.7
    nb_best_hits: int = 100
    minimap_preset: str = "sr"
    minimap_extra_params: str = "--eqx"

    # --- performance parameters (config.yaml:44-125) ---
    threads: int | str = "all"
    max_ram_gb: int = 12
    max_download_threads: int = 8
    download_retries: int = 3
    download_retry_wait: int = 10
    download_dir: str = "."
    cobs_threads: int | str = "auto"
    index_load_mode: str = "mem-stream"  # mem-stream | mem-disk | mmap-disk
    max_io_heavy_threads: int = 8
    minimap_threads: int = 1
    prefer_pipe: bool = True

    # --- misc (config.yaml:128-139) ---
    keep_cobs_indexes: bool = False
    decompression_dir: str | None = None

    # --- device extensions (no reference equivalent) ---
    # device-memory budget (GB) for resident batch indexes and align
    # buffers. "auto" takes what JAX may allocate on the device
    # (memory_stats()["bytes_limit"]); a number pins it.
    device_hbm_gb: float | str = "auto"
    # device-resident index cache (content-hash keyed): repeated runs over
    # the same batches skip the index H2D upload entirely. Carved out of the
    # device budget at pipeline init; 0 disables.
    device_index_cache_gb: float = 4.0
    # queries per match device call. Each call has a fixed dispatch+fetch
    # cost, so bigger chunks amortize it; the [Q, 32*Wp] transient score
    # matrix bounds it above (8192 x 2176 x 4 B = 71 MB at the largest real
    # batch width). "auto" sizes the chunk per batch so that matrix stays
    # under ~256 MB (=> 8192 queries at the largest real 661k batch width,
    # 32k+ at typical widths); an integer pins it.
    device_query_chunk: int | str = "auto"
    # decoded-genome disk cache for assembly tars: one sequential tar.xz
    # pass per batch writes 2-bit-coded contigs to
    # intermediate/02_asms_decoded/, and later align runs mmap ONLY the
    # candidate genomes' bytes instead of re-streaming the whole archive
    # (the asm analogue of keep_cobs_indexes; costs ~decompressed-genome
    # disk per batch — disable at full 661k scale if disk is tight).
    asm_cache: bool = True
    # combined disk budget (GB) for the two persistent caches above (the
    # device-format index cache and the decoded-asm cache): least-recently
    # -used batch entries are evicted once the total crosses the budget,
    # so a full-661k run cannot grow unboundedly past the reference's
    # documented ~120 GB disk contract (README.md:95-96). <= 0 disables
    # eviction. Enforcement runs after each cache build, so transient
    # overshoot is bounded by the in-flight batches' sizes.
    cache_max_disk_gb: float = 50.0
    # cross-query k-mer dedup in the match kernel (two-stage gather,
    # bit-identical output). Opt-in: the host-side unique pass only pays
    # off where it is cheaper than the device time it saves.
    match_dedup: bool = False
    # align pairs pooled per device flush (bigger pools amortize the fixed
    # per-flush dispatch/fetch cost; FUSED_MAX_CELLS still splits oversized
    # chunks on device). Not yet tuned on the H100 (ROADMAP queue 1).
    device_pair_chunk: int = 16384
    mesh_shape: str = "1x1"  # doc-shard x data-parallel mesh (parallel.mesh)
    filter_mode: str = "auto"  # auto (native arrays when available) | streaming
    output_dir: str = "output"
    intermediate_dir: str = "intermediate"
    logs_dir: str = "logs"

    def effective_threads(self) -> int:
        if self.threads == "all":
            return os.cpu_count() or 1
        return int(self.threads)

    def device_budget_mb(self) -> int:
        """The device-memory budget in MB (``device_hbm_gb`` resolved)."""
        if self.device_hbm_gb == "auto":
            from phylign_tpu.utils.platform import device_memory_mb

            return device_memory_mb()
        return int(float(self.device_hbm_gb) * 1024)

    @classmethod
    def from_yaml(cls, path: str | os.PathLike) -> "Config":
        return cls.from_dict(load_flat_yaml(Path(path).read_text()))

    @classmethod
    def from_dict(cls, data: dict[str, Any]) -> "Config":
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(data) - known
        if unknown:
            raise ValueError(f"unknown config keys: {sorted(unknown)}")
        for key in sorted(set(data) & set(INERT_KEYS)):
            log.warning(
                "config key %r accepted for compatibility but has no effect: %s",
                key, INERT_KEYS[key],
            )
        cfg = cls(**data)
        if cfg.nb_best_hits < 1:
            # the reference crashes on nb_best_hits=0 deep inside
            # filter_queries.py _housekeeping (IndexError on an empty
            # list); fail loudly at config load instead
            raise ValueError(
                f"nb_best_hits must be >= 1 (got {cfg.nb_best_hits})"
            )
        if not 0.0 <= float(cfg.cobs_kmer_thres) <= 1.0:
            raise ValueError(
                f"cobs_kmer_thres must be in [0, 1] (got {cfg.cobs_kmer_thres})"
            )
        if isinstance(cfg.device_hbm_gb, str) and cfg.device_hbm_gb != "auto":
            raise ValueError(
                f"device_hbm_gb must be a number or 'auto' "
                f"(got {cfg.device_hbm_gb!r})"
            )
        return cfg

    def with_overrides(self, **kw: Any) -> "Config":
        return dataclasses.replace(self, **{k: v for k, v in kw.items() if v is not None})


# --- the flat key: value subset of YAML ---------------------------------------

_KEY_LINE = re.compile(r"([A-Za-z_][\w.-]*)[ \t]*:(?:[ \t]+(.*))?$")
_INT = re.compile(r"[-+]?[0-9]+$")
_FLOAT = re.compile(
    r"[-+]?(?:[0-9]+\.[0-9]*|\.[0-9]+|[0-9]+)(?:[eE][-+]?[0-9]+)?$"
)
_SQUOTED = re.compile(r"'((?:[^']|'')*)'")  # '' escapes one quote
_BOOLS = {
    "true": True, "yes": True, "on": True,
    "false": False, "no": False, "off": False,
}


def _flat_scalar(raw: str, where: str) -> Any:
    """One YAML scalar: quoted string, bool, null, int, float or plain
    string, with an optional trailing ``#`` comment."""
    v = raw.strip()
    if v[:1] in ("'", '"'):
        if v[0] == '"':
            try:
                val, end = json.JSONDecoder().raw_decode(v)
            except ValueError as e:
                raise ValueError(f"{where}: bad double-quoted string") from e
        else:
            m = _SQUOTED.match(v)
            if m is None:
                raise ValueError(f"{where}: unterminated single quote")
            val, end = m.group(1).replace("''", "'"), m.end()
        rest = v[end:].strip()
        if rest and not rest.startswith("#"):
            raise ValueError(f"{where}: text after a quoted string")
        return val
    v = re.split(r"[ \t]#", v, maxsplit=1)[0].strip()
    if v.startswith("#"):
        v = ""
    if v[:1] in ("[", "{", "&", "*", "!", "|", ">") or v == "-" or (
        v.startswith("- ") or ": " in v
    ):
        raise ValueError(
            f"{where}: only flat 'key: scalar' lines are supported "
            f"(no lists, mappings, anchors, tags or block scalars): {raw!r}"
        )
    low = v.lower()
    if low in ("", "~", "null"):
        return None
    if low in _BOOLS:
        return _BOOLS[low]
    if _INT.match(v):
        return int(v)
    if _FLOAT.match(v):
        return float(v)
    return v


def load_flat_yaml(text: str) -> dict[str, Any]:
    """Parse a flat ``key: value`` YAML document (the reference's
    config.yaml shape). Anything nested is rejected, saying why."""
    out: dict[str, Any] = {}
    for n, line in enumerate(text.splitlines(), 1):
        body = line.rstrip()
        if not body.strip() or body.lstrip().startswith("#"):
            continue
        if n == 1 and body == "---":
            continue
        if body[0] in " \t":
            raise ValueError(
                f"line {n}: indented line; nested mappings and lists are "
                f"not supported: {line!r}"
            )
        m = _KEY_LINE.match(body)
        if m is None:
            raise ValueError(
                f"line {n}: expected a flat 'key: value' line: {line!r}"
            )
        key = m.group(1)
        if key in out:
            raise ValueError(f"line {n}: duplicate key {key!r}")
        out[key] = _flat_scalar(m.group(2) or "", f"line {n}")
    return out


def _plain_ok(v: str) -> bool:
    """Whether a string can be written unquoted and read back unchanged."""
    try:
        return (
            v == v.strip() and "#" not in v and _flat_scalar(v, "") == v
        )
    except ValueError:
        return False


def dump_flat_yaml(data: dict[str, Any]) -> str:
    """Write scalars as flat ``key: value`` lines that load_flat_yaml reads
    back to the same values (strings plain where that is unambiguous,
    double-quoted otherwise)."""
    lines = []
    for key, v in data.items():
        if v is None:
            s = "null"
        elif isinstance(v, bool):
            s = "true" if v else "false"
        elif isinstance(v, (int, float)):
            s = repr(v)
        elif isinstance(v, str):
            s = v if _plain_ok(v) else json.dumps(v)
        else:
            raise TypeError(f"{key}: only scalar values can be written")
        lines.append(f"{key}: {s}")
    return "".join(line + "\n" for line in lines)
