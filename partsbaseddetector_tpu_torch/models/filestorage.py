"""OpenCV-FileStorage-compatible model (de)serialization, dependency-free
(the port's own copy of ``partsbaseddetector_tpu/models/filestorage.py``).

The reference stores models as OpenCV ``cv::FileStorage`` XML/YAML files with
the schema written by ``FileStorageModel::serialize``
(reference: src/FileStorageModel.cpp:42-94) and read back by
``FileStorageModel::deserialize`` (reference: src/FileStorageModel.cpp:96-159):

    name, interval, thresh, sbin, norient, flen      -- scalars
    filtersw  -- sequence of opencv-matrix (rows x cols, flattened H x (W*C))
    biasw     -- sequence of floats
    anchors   -- sequence of [ax, ay] int pairs (0-based, ModelTransfer output)
    defs      -- sequence of [w0, w1, w2, w3] float quadruples
    indexers  -- map: component-<c> -> part-<p> ->
                 {parentid, filterid, biasid, defid}

This module implements a from-scratch parser/emitter for the OpenCV
FileStorage container (the XML dialect and the YAML subset OpenCV emits, both
"%YAML:1.0" and "%YAML 1.2" headers) plus the mapping to/from
:class:`PartsModel`.  It does NOT depend on cv2; tests cross-validate the
format against cv2 when available.

Deviation from the reference (documented, deliberate): the reference's
deserializer collapses sequence-valued ``defid`` to ``[0]``
(src/FileStorageModel.cpp:148-152), losing per-mixture anchors for any model
its own serializer wrote.  We read sequence defids faithfully.
"""

from __future__ import annotations

import re
import xml.etree.ElementTree as ET
from typing import Any, Dict, List, Union

import numpy as np

from partsbaseddetector_tpu_torch.models.schema import (
    ComponentSpec, PartSpec, PartsModel, flatten_filter, unflatten_filter)

# --------------------------------------------------------------------------
# generic FileStorage document model:
#   map -> dict, seq -> list, opencv-matrix -> np.ndarray, scalars -> int/
#   float/str
# --------------------------------------------------------------------------

_DT_TO_NP = {"d": np.float64, "f": np.float32, "i": np.int32,
             "u": np.uint8, "s": np.int16, "w": np.uint16}
_NP_TO_DT = {np.dtype(np.float64): "d", np.dtype(np.float32): "f",
             np.dtype(np.int32): "i", np.dtype(np.uint8): "u",
             np.dtype(np.int16): "s", np.dtype(np.uint16): "w"}

_INT_RE = re.compile(r"^[+-]?\d+$")
_FLOAT_RE = re.compile(
    r"^[+-]?(\d+\.?\d*|\.\d+)([eE][+-]?\d+)?$|^[+-]?\d+\.$")


def _parse_scalar(tok: str) -> Union[int, float, str]:
    if _INT_RE.match(tok):
        return int(tok)
    if _FLOAT_RE.match(tok):
        return float(tok)
    if len(tok) >= 2 and tok[0] == '"' and tok[-1] == '"':
        return tok[1:-1]
    return tok


# ------------------------------------------------------------ XML reading

def _xml_node_value(el: ET.Element) -> Any:
    if el.get("type_id") == "opencv-matrix":
        sub = {c.tag: _xml_node_value(c) for c in el}
        rows, cols = int(sub["rows"]), int(sub["cols"])
        dt = str(sub["dt"])
        data = sub["data"]
        if not isinstance(data, list):
            data = [data]
        arr = np.array(data, dtype=_DT_TO_NP.get(dt[-1], np.float64))
        return arr.reshape(rows, cols)
    children = list(el)
    if children:
        if all(c.tag == "_" for c in children):
            return [_xml_node_value(c) for c in children]
        return {c.tag: _xml_node_value(c) for c in children}
    text = (el.text or "").strip()
    if not text:
        return None
    toks = text.split()
    if len(toks) == 1:
        return _parse_scalar(toks[0])
    # OpenCV never splits a single string scalar across tokens unless quoted
    if text.startswith('"'):
        return _parse_scalar(text)
    return [_parse_scalar(t) for t in toks]


def read_filestorage_xml(path: str) -> Dict[str, Any]:
    root = ET.parse(path).getroot()
    if root.tag != "opencv_storage":
        raise ValueError(f"{path}: not an OpenCV FileStorage XML file")
    return {c.tag: _xml_node_value(c) for c in root}


# ------------------------------------------------------------ XML writing

def _fmt_scalar(v: Any) -> str:
    if isinstance(v, (bool, np.bool_)):
        return "1" if v else "0"
    if isinstance(v, (int, np.integer)):
        return str(int(v))
    if isinstance(v, (float, np.floating)):
        return repr(float(v))
    return str(v)


def _xml_write_value(lines: List[str], tag: str, v: Any, indent: int) -> None:
    pad = " " * indent
    if isinstance(v, np.ndarray) and v.ndim == 2:
        dt = _NP_TO_DT[v.dtype]
        data = " ".join(_fmt_scalar(x) for x in v.ravel())
        lines.append(f'{pad}<{tag} type_id="opencv-matrix">')
        lines.append(f"{pad}  <rows>{v.shape[0]}</rows>")
        lines.append(f"{pad}  <cols>{v.shape[1]}</cols>")
        lines.append(f"{pad}  <dt>{dt}</dt>")
        lines.append(f"{pad}  <data>{data}</data></{tag}>")
    elif isinstance(v, dict):
        lines.append(f"{pad}<{tag}>")
        for k, sub in v.items():
            _xml_write_value(lines, k, sub, indent + 2)
        lines.append(f"{pad}</{tag}>")
    elif isinstance(v, (list, tuple)) or (
            isinstance(v, np.ndarray) and v.ndim == 1):
        seq = list(v)
        if seq and all(isinstance(x, (dict, list, tuple, np.ndarray))
                       for x in seq):
            lines.append(f"{pad}<{tag}>")
            for x in seq:
                _xml_write_value(lines, "_", x, indent + 2)
            lines.append(f"{pad}</{tag}>")
        else:
            body = " ".join(_fmt_scalar(x) for x in seq)
            lines.append(f"{pad}<{tag}>{body}</{tag}>")
    elif isinstance(v, str):
        # quote if it could parse as a number or has spaces
        if (_INT_RE.match(v) or _FLOAT_RE.match(v) or " " in v or not v):
            v = f'"{v}"'
        lines.append(f"{pad}<{tag}>{v}</{tag}>")
    else:
        lines.append(f"{pad}<{tag}>{_fmt_scalar(v)}</{tag}>")


def write_filestorage_xml(path: str, doc: Dict[str, Any]) -> None:
    lines = ['<?xml version="1.0"?>', "<opencv_storage>"]
    for k, v in doc.items():
        _xml_write_value(lines, k, v, 0)
    lines.append("</opencv_storage>")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


# ------------------------------------------------------------ YAML reading
# A minimal parser for the YAML subset OpenCV emits (block maps/sequences,
# flow sequences incl. multi-line, !!opencv-matrix tags, quoted strings).

def _yaml_logical_lines(text: str):
    """Yield (indent, content) with multi-line flow sequences joined."""
    raw = text.splitlines()
    i = 0
    while i < len(raw):
        line = raw[i]
        i += 1
        stripped = line.split("#", 1)[0].rstrip()
        if not stripped.strip():
            continue
        if stripped.strip().startswith("%") or stripped.strip() == "---":
            continue
        # join continuation lines while brackets are unbalanced
        while stripped.count("[") > stripped.count("]") and i < len(raw):
            stripped += " " + raw[i].split("#", 1)[0].strip()
            i += 1
        indent = len(stripped) - len(stripped.lstrip())
        yield indent, stripped.strip()


def _yaml_scalar(text: str) -> Any:
    text = text.strip()
    if text.startswith("[") and text.endswith("]"):
        inner = text[1:-1].strip()
        if not inner:
            return []
        return [_yaml_scalar(t) for t in _split_flow(inner)]
    if len(text) >= 2 and text[0] in "\"'" and text[-1] == text[0]:
        return text[1:-1]
    return _parse_scalar(text)


def _split_flow(inner: str) -> List[str]:
    out, depth, cur = [], 0, []
    for ch in inner:
        if ch == "[":
            depth += 1
            cur.append(ch)
        elif ch == "]":
            depth -= 1
            cur.append(ch)
        elif ch == "," and depth == 0:
            out.append("".join(cur).strip())
            cur = []
        else:
            cur.append(ch)
    if cur and "".join(cur).strip():
        out.append("".join(cur).strip())
    return out


def _yaml_parse_block(lines: List, pos: int, indent: int):
    """Parse a block starting at lines[pos] with given indent.
    Returns (value, next_pos)."""
    if pos >= len(lines):
        return None, pos
    ind, content = lines[pos]
    if content == "-" or content.startswith("- "):
        # sequence
        seq = []
        while pos < len(lines):
            ind, content = lines[pos]
            if ind != indent or not (content == "-"
                                     or content.startswith("- ")):
                break
            item = content[1:].strip()
            pos += 1
            if item == "!!opencv-matrix" or item.startswith("!!"):
                sub, pos = _yaml_parse_block(lines, pos, _next_indent(
                    lines, pos, indent))
                seq.append(_maybe_matrix(sub, tagged=True))
            elif not item:
                sub, pos = _yaml_parse_block(lines, pos, _next_indent(
                    lines, pos, indent))
                seq.append(sub)
            elif ":" in item and not item.startswith("["):
                # inline start of a nested map: re-parse as map with deeper
                # indent; the first key is inline after '- '
                key, rest = item.split(":", 1)
                m = {}
                if rest.strip():
                    m[key.strip()] = _yaml_scalar(rest)
                else:
                    sub, pos = _yaml_parse_block(lines, pos, _next_indent(
                        lines, pos, indent))
                    m[key.strip()] = sub
                # continuation keys at deeper indent
                while pos < len(lines) and lines[pos][0] > indent:
                    sub, pos = _yaml_parse_map_entries(lines, pos,
                                                      lines[pos][0], m)
                seq.append(_maybe_matrix(m))
            else:
                seq.append(_yaml_scalar(item))
        return seq, pos
    # map
    m: Dict[str, Any] = {}
    while pos < len(lines):
        ind, content = lines[pos]
        if ind != indent or content == "-" \
                or content.startswith("- "):
            break
        pos = _yaml_parse_map_entry(lines, pos, indent, m)
    return m, pos


def _yaml_parse_map_entry(lines, pos, indent, m):
    ind, content = lines[pos]
    if ":" not in content:
        raise ValueError(f"bad YAML map line: {content!r}")
    key, rest = content.split(":", 1)
    key, rest = key.strip(), rest.strip()
    pos += 1
    if rest and not rest.startswith("!!"):
        m[key] = _yaml_scalar(rest)
    elif rest.startswith("!!"):
        sub, pos = _yaml_parse_block(lines, pos,
                                     _next_indent(lines, pos, indent))
        m[key] = _maybe_matrix(sub, tagged=True)
    else:
        if pos < len(lines) and lines[pos][0] > indent:
            sub, pos = _yaml_parse_block(lines, pos, lines[pos][0])
            m[key] = _maybe_matrix(sub)
        else:
            m[key] = None
    return pos


def _yaml_parse_map_entries(lines, pos, indent, m):
    while pos < len(lines) and lines[pos][0] == indent \
            and lines[pos][1] != "-" \
            and not lines[pos][1].startswith("- "):
        pos = _yaml_parse_map_entry(lines, pos, indent, m)
    return pos


def _next_indent(lines, pos, indent):
    if pos < len(lines) and lines[pos][0] > indent:
        return lines[pos][0]
    return indent + 1


def _maybe_matrix(v: Any, tagged: bool = False) -> Any:
    if (isinstance(v, dict) and {"rows", "cols", "dt", "data"} <= set(v)):
        dt = str(v["dt"])
        data = v["data"]
        if not isinstance(data, list):
            data = [data]
        arr = np.array(data, dtype=_DT_TO_NP.get(dt[-1], np.float64))
        return arr.reshape(int(v["rows"]), int(v["cols"]))
    return v


def read_filestorage_yaml(path: str) -> Dict[str, Any]:
    with open(path) as f:
        text = f.read()
    lines = list(_yaml_logical_lines(text))
    if not lines:
        return {}
    doc, _ = _yaml_parse_block(lines, 0, lines[0][0])
    if not isinstance(doc, dict):
        raise ValueError(f"{path}: top-level FileStorage node must be a map")
    return doc


# ------------------------------------------------------------ YAML writing

def _yaml_write(lines: List[str], key: str, v: Any, indent: int) -> None:
    pad = " " * indent
    if isinstance(v, np.ndarray) and v.ndim == 2:
        head = f"{pad}{key}: !!opencv-matrix" if key else \
            f"{pad}- !!opencv-matrix"
        lines.append(head)
        p2 = " " * (indent + 3)
        lines.append(f"{p2}rows: {v.shape[0]}")
        lines.append(f"{p2}cols: {v.shape[1]}")
        lines.append(f"{p2}dt: {_NP_TO_DT[v.dtype]}")
        data = ", ".join(_fmt_scalar(x) for x in v.ravel())
        lines.append(f"{p2}data: [ {data} ]")
    elif isinstance(v, dict):
        lines.append(f"{pad}{key}:" if key else f"{pad}-")
        for k, sub in v.items():
            _yaml_write(lines, k, sub, indent + 3)
    elif isinstance(v, (list, tuple)) or (
            isinstance(v, np.ndarray) and v.ndim == 1):
        seq = list(v)
        if seq and all(not isinstance(x, (dict, list, tuple, np.ndarray))
                       for x in seq):
            if key:
                body = ", ".join(_fmt_scalar(x) for x in seq)
                lines.append(f"{pad}{key}: [ {body} ]")
            else:
                body = ", ".join(_fmt_scalar(x) for x in seq)
                lines.append(f"{pad}- [ {body} ]")
        else:
            lines.append(f"{pad}{key}:" if key else f"{pad}-")
            for x in seq:
                if isinstance(x, (dict, np.ndarray)):
                    _yaml_write(lines, "", x, indent + 3)
                elif isinstance(x, (list, tuple)):
                    body = ", ".join(_fmt_scalar(e) for e in x)
                    lines.append(f"{' ' * (indent + 3)}- [ {body} ]")
                else:
                    lines.append(
                        f"{' ' * (indent + 3)}- {_fmt_scalar(x)}")
    elif isinstance(v, str):
        if _INT_RE.match(v) or _FLOAT_RE.match(v) or not v:
            v = f'"{v}"'
        lines.append(f"{pad}{key}: {v}")
    else:
        lines.append(f"{pad}{key}: {_fmt_scalar(v)}")


def write_filestorage_yaml(path: str, doc: Dict[str, Any]) -> None:
    lines = ["%YAML:1.0", "---"]
    for k, v in doc.items():
        _yaml_write(lines, k, v, 0)
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def read_filestorage(path: str) -> Dict[str, Any]:
    if path.endswith(".xml"):
        return read_filestorage_xml(path)
    if path.endswith((".yml", ".yaml")):
        return read_filestorage_yaml(path)
    raise ValueError(f"unrecognized FileStorage extension: {path}")


def write_filestorage(path: str, doc: Dict[str, Any]) -> None:
    if path.endswith(".xml"):
        return write_filestorage_xml(path, doc)
    if path.endswith((".yml", ".yaml")):
        return write_filestorage_yaml(path, doc)
    raise ValueError(f"unrecognized FileStorage extension: {path}")


# --------------------------------------------------------------------------
# PartsModel <-> FileStorage document
# --------------------------------------------------------------------------

def _as_list(v: Any) -> List:
    if v is None:
        return []
    if isinstance(v, np.ndarray):
        return v.ravel().tolist()
    if isinstance(v, (list, tuple)):
        return list(v)
    return [v]


def model_to_doc(model: PartsModel) -> Dict[str, Any]:
    """PartsModel -> FileStorage document in the reference schema
    (reference: src/FileStorageModel.cpp:42-94)."""
    indexers: Dict[str, Any] = {}
    for c, comp in enumerate(model.components):
        comp_doc: Dict[str, Any] = {}
        for p, part in enumerate(comp.parts):
            comp_doc[f"part-{p}"] = {
                "parentid": int(part.parentid),
                "filterid": [int(i) for i in part.filterid],
                "biasid": [int(i) for i in part.biasid],
                "defid": [int(i) for i in part.defid],
            }
        indexers[f"component-{c}"] = comp_doc
    return {
        "name": model.name,
        "interval": int(model.interval),
        "thresh": float(model.thresh),
        "sbin": int(model.binsize),
        "norient": int(model.norient),
        "flen": int(model.flen),
        "filtersw": [flatten_filter(np.asarray(f, dtype=np.float64))
                     for f in model.filters],
        "biasw": [float(b) for b in model.biasw],
        "anchors": [[int(a[0]), int(a[1])] for a in model.anchors],
        "defs": [[float(x) for x in d] for d in model.defw],
        "indexers": indexers,
    }


def doc_to_model(doc: Dict[str, Any]) -> PartsModel:
    """FileStorage document -> PartsModel
    (field mapping per reference: src/FileStorageModel.cpp:104-153; note
    "interval" is the per-octave level count — the reference stores it in
    nscales_ and aliases interval_ to it, include/HOGFeatures.hpp:76-78)."""
    flen = int(doc["flen"])
    filters = [unflatten_filter(np.asarray(f, dtype=np.float64), flen)
               for f in doc["filtersw"]]
    anchors = [np.asarray(_as_list(a), dtype=np.int64)
               for a in doc.get("anchors", [])]
    defw = [np.asarray(_as_list(d), dtype=np.float64)
            for d in doc.get("defs", [])]
    biasw = np.asarray(_as_list(doc.get("biasw", [])), dtype=np.float64)

    components: List[ComponentSpec] = []
    indexers = doc.get("indexers", {})
    for c in range(len(indexers)):
        comp = indexers[f"component-{c}"]
        parts: List[PartSpec] = []
        for p in range(len(comp)):
            node = comp[f"part-{p}"]
            defid = node.get("defid", 0)
            parts.append(PartSpec(
                parentid=int(node["parentid"]),
                filterid=[int(i) for i in _as_list(node["filterid"])],
                biasid=[int(i) for i in _as_list(node["biasid"])],
                defid=[int(i) for i in _as_list(defid)],
            ))
        components.append(ComponentSpec(parts=parts))

    model = PartsModel(
        name=str(doc.get("name", "model")),
        interval=int(doc["interval"]),
        thresh=float(doc["thresh"]),
        binsize=int(doc["sbin"]),
        norient=int(doc["norient"]),
        flen=flen,
        filters=filters, defw=defw, anchors=anchors, biasw=biasw,
        components=components,
    )
    model.validate()
    return model


def load_model(path: str) -> PartsModel:
    return doc_to_model(read_filestorage(path))


def save_model(path: str, model: PartsModel) -> None:
    write_filestorage(path, model_to_doc(model))
