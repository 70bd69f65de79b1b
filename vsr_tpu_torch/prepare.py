"""One-command model bootstrap: reference checkpoint tree -> .npz directory.

A copy of ``vsr_tpu/prepare.py`` that needs torch and numpy, not jax. The
reference resolves model paths from a fixed layout under `backend/models/`
and reassembles split blobs through filesplit manifests before first use
(backend/tools/model_config.py:11-28, backend/tools/common_tools.py:40-45).
Point this module at a reference-format `models/` directory and it

  1. merges any `fs_manifest.csv` split blobs (filesplit format: ordered
     `<stem>_<i>.<ext>` parts concatenated back into `<stem>.<ext>`),
  2. runs every family converter whose source checkpoint exists
     (``convert/``, the port's copies of the JAX package's),
  3. verifies each written .npz round-trips with the exact key set the
     converter produced, and loads strict into the port's module at the
     width the pipeline builds (``load_into_port``),
  4. prints a summary of what was converted and what is missing.

The .npz files are the JAX package's format: either package reads them.

CLI:  python -m vsr_tpu_torch --prepare-models <ref_models_dir> [--models <out_dir>]
"""

from __future__ import annotations

import csv
import os
from typing import Callable, Dict, List, Optional, Tuple

# family -> (relative source path, output npz name)
#
# V5/ch_det is PP-OCRv5 server, ch_det_fast is mobile
# (backend/tools/model_config.py:17-22). The pipeline loads `dbnet.npz`
# (pipeline.py `_ckpt("dbnet.npz")`); the server det is the
# reference default, so it lands there and the mobile det is written
# alongside as dbnet_mobile.npz for configs that select the fast mode.
FAMILIES: List[Tuple[str, str, str]] = [
    ("sttn-auto", "sttn-auto/infer_model.pth", "sttn_auto.npz"),
    ("sttn-det", "sttn-det/sttn.pth", "sttn_det.npz"),
    ("lama", "big-lama/big-lama.pt", "lama.npz"),
    ("raft", "propainter/raft-things.pth", "raft.npz"),
    ("flow-completion", "propainter/recurrent_flow_completion.pth",
     "flow_completion.npz"),
    ("propainter", "propainter/ProPainter.pth", "propainter.npz"),
    ("dbnet-server", "V5/ch_det/inference.pdiparams", "dbnet.npz"),
    ("dbnet-mobile", "V5/ch_det_fast/inference.pdiparams",
     "dbnet_mobile.npz"),
]


def merge_split_blobs(directory: str) -> Optional[str]:
    """Reassemble one filesplit archive in ``directory`` if present.

    Returns the merged file path (existing or newly written), or None when
    the directory holds no manifest. Matches fsplit.filesplit.Filesplit.merge
    semantics: parts listed in fs_manifest.csv are concatenated in order;
    the output name strips the final ``_<i>`` from the part stem."""
    manifest = os.path.join(directory, "fs_manifest.csv")
    if not os.path.exists(manifest):
        return None
    with open(manifest, newline="") as f:
        rows = [r for r in csv.DictReader(f) if r.get("filename")]
    if not rows:
        return None
    stem, ext = os.path.splitext(rows[0]["filename"])
    base = stem.rsplit("_", 1)[0]
    out_path = os.path.join(directory, base + ext)
    if os.path.exists(out_path):
        return out_path
    parts = [os.path.join(directory, r["filename"]) for r in rows]
    missing = [p for p in parts if not os.path.exists(p)]
    if missing:
        raise FileNotFoundError(
            f"split-blob parts missing in {directory}: "
            + ", ".join(os.path.basename(p) for p in missing))
    tmp = out_path + ".merging"
    with open(tmp, "wb") as out:
        for p, row in zip(parts, rows):
            expect = int(row["filesize"]) if row.get("filesize") else None
            with open(p, "rb") as part:
                data = part.read()
            if expect is not None and len(data) != expect:
                raise IOError(
                    f"{p}: size {len(data)} != manifest {expect}")
            out.write(data)
    os.replace(tmp, out_path)
    return out_path


def _convert(family: str, path: str) -> Dict:
    from vsr_tpu_torch.convert.__main__ import _load

    return _load(family, path)


def _port_model(family: str):
    """(the port's module for ``family`` at the pipeline's width, its loader)."""
    from vsr_tpu_torch.inpaint import weights

    if family in ("sttn-auto", "sttn-det"):
        from vsr_tpu_torch.models.sttn import STTNGenerator

        return STTNGenerator(variant=family.split("-")[1]), weights.load_sttn_weights
    if family == "lama":
        from vsr_tpu_torch.models.lama import LamaGenerator

        return LamaGenerator(), weights.load_lama_weights
    if family == "raft":
        from vsr_tpu_torch.models.propainter.raft import RAFT

        return RAFT(), weights.load_raft_weights
    if family == "flow-completion":
        from vsr_tpu_torch.models.propainter.flow_completion import RecurrentFlowCompleteNet

        return RecurrentFlowCompleteNet(), weights.load_flow_completion_weights
    if family == "propainter":
        from vsr_tpu_torch.models.propainter.generator import ProPainterGenerator

        return ProPainterGenerator(), weights.load_propainter_weights
    if family in ("dbnet-server", "dbnet-mobile"):
        from vsr_tpu_torch.detect.dbnet import DBNet

        return DBNet(preset=family.split("-")[1]), weights.load_dbnet_weights
    raise ValueError(f"unknown family: {family}")


def load_into_port(family: str, npz_path: str) -> None:
    """Load ``npz_path`` strict into the port's module for ``family`` on the
    CPU; raises on a missing, extra or misshapen tensor."""
    model, load = _port_model(family)
    load(model, npz_path)


def prepare_models(
    src_dir: str,
    out_dir: str,
    families: Optional[List[str]] = None,
    convert_fn: Callable[[str, str], Dict] = _convert,
    log: Callable[[str], None] = print,
    check_fn: Callable[[str, str], None] = load_into_port,
) -> Dict[str, str]:
    """Convert every available reference checkpoint under ``src_dir``.

    Returns {family: status} where status is "converted", "exists",
    "missing", or "error: ...". Existing up-to-date outputs are skipped.
    ``check_fn(family, npz_path)`` runs on each written file and raises when
    it does not load (default: load_into_port)."""
    os.makedirs(out_dir, exist_ok=True)

    # split blobs live beside their manifests (big-lama/, propainter/)
    merge_errors: Dict[str, str] = {}
    for sub in ("big-lama", "propainter"):
        d = os.path.join(src_dir, sub)
        if os.path.isdir(d):
            try:
                merged = merge_split_blobs(d)
                if merged:
                    log(f"[prepare] merged split blob: {merged}")
            except (FileNotFoundError, IOError) as e:
                # recorded per family below: a corrupt/incomplete split blob
                # must fail the CLI, not report as a benign "missing"
                merge_errors[sub] = str(e)
                log(f"[prepare] split-blob merge failed in {d}: {e}")

    from vsr_tpu_torch.convert.mapping import flatten_tree
    from vsr_tpu_torch.convert.params_io import load_params, save_params

    results: Dict[str, str] = {}
    for family, rel, out_name in FAMILIES:
        if families and family not in families:
            continue
        src = os.path.join(src_dir, rel)
        dst = os.path.join(out_dir, out_name)
        if not os.path.exists(src):
            sub = rel.split("/", 1)[0]
            if sub in merge_errors:
                results[family] = (
                    f"error: split-blob merge failed: {merge_errors[sub]}")
                log(f"[prepare] {family}: FAILED (split-blob merge: "
                    f"{merge_errors[sub]})")
            else:
                results[family] = "missing"
                log(f"[prepare] {family}: MISSING {rel}")
            continue
        if (os.path.exists(dst)
                and os.path.getmtime(dst) >= os.path.getmtime(src)):
            results[family] = "exists"
            log(f"[prepare] {family}: up to date ({out_name})")
            continue
        try:
            variables = convert_fn(family, src)
            save_params(dst, variables)
            # key-completeness: the npz must round-trip the converter's tree
            src_paths = set(flatten_tree(variables))
            dst_paths = set(flatten_tree(load_params(dst)))
            if src_paths != dst_paths:
                raise ValueError(
                    f"round-trip key mismatch: {len(src_paths)} converted "
                    f"vs {len(dst_paths)} reloaded")
            check_fn(family, dst)
            results[family] = "converted"
            log(f"[prepare] {family}: {rel} -> {out_name} "
                f"({os.path.getsize(dst) / 1e6:.1f} MB, "
                f"{len(dst_paths)} arrays)")
        except Exception as e:  # keep converting the other families
            # a file that failed its checks must not read as up to date next time
            if os.path.exists(dst) and os.path.getmtime(dst) >= os.path.getmtime(src):
                os.remove(dst)
            results[family] = f"error: {e}"
            log(f"[prepare] {family}: FAILED ({e})")

    done = sum(1 for s in results.values() if s in ("converted", "exists"))
    log(f"[prepare] {done}/{len(results)} families ready in {out_dir}")
    missing = [f for f, s in results.items() if s == "missing"]
    if missing:
        log("[prepare] missing sources (place the reference checkpoints "
            "under the layout in vsr_tpu_torch/prepare.py FAMILIES): "
            + ", ".join(missing))
    return results
