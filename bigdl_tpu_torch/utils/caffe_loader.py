"""Caffe .caffemodel weight importer (counterpart of
bigdl_tpu/utils/caffe_loader.py; ref utils/CaffeLoader.scala:40).

The reference ships 96k LoC of protoc-generated Java (caffe/Caffe.java) to
read NetParameter; here a ~100-line protobuf *wire-format* parser extracts
exactly what weight-copy needs — layer names and blobs — with no protobuf
dependency and no generated code.

Field numbers (from caffe.proto):
  NetParameter:    layers = 2 (V1LayerParameter), layer = 100 (LayerParameter)
  V1LayerParameter: name = 4, blobs = 6
  LayerParameter:   name = 1, type = 2, blobs = 7
  BlobProto: num/channels/height/width = 1..4, data = 5 (packed or repeated
             float), shape = 7 (BlobShape.dim = 1, repeated int64)

``load(model, caffemodel_path)`` copies blobs onto modules by matched
``set_name`` (the name-matched copy of CaffeLoader.copyParameters :127),
with ``match_all`` enforcing full coverage (CaffeLoader.load :155).  The
copy is in place (``copy_`` on each parameter, on its device and in its
dtype), so an optimizer's or a captured graph's references stay valid.
"""
from __future__ import annotations

import numpy as np


def _read_varint(buf, pos):
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def iter_fields(buf, start=0, end=None):
    """Yield (field_number, wire_type, value) over a protobuf message.
    value: varint int, 8-byte chunk, length-delimited bytes, or 4-byte chunk."""
    pos = start
    end = len(buf) if end is None else end
    while pos < end:
        tag, pos = _read_varint(buf, pos)
        field, wire = tag >> 3, tag & 7
        if wire == 0:
            val, pos = _read_varint(buf, pos)
        elif wire == 1:
            val = buf[pos:pos + 8]
            pos += 8
        elif wire == 2:
            n, pos = _read_varint(buf, pos)
            val = buf[pos:pos + n]
            pos += n
        elif wire == 5:
            val = buf[pos:pos + 4]
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wire}")
        yield field, wire, val


def _parse_blob(buf):
    """BlobProto -> numpy array with caffe shape."""
    dims_old = {}
    shape = None
    data = []
    for field, wire, val in iter_fields(buf):
        if field in (1, 2, 3, 4) and wire == 0:
            dims_old[field] = val
        elif field == 5:
            if wire == 2:  # packed floats
                data.append(np.frombuffer(val, np.float32))
            else:  # unpacked single float
                data.append(np.frombuffer(val, np.float32))
        elif field == 7 and wire == 2:  # BlobShape
            shape = [v for f, w, v in iter_fields(val) if f == 1 and w == 0]
        elif field == 8 and wire == 2:  # double_data
            data.append(np.frombuffer(val, np.float64).astype(np.float32))
    arr = np.concatenate(data) if data else np.zeros(0, np.float32)
    if shape:
        return arr.reshape(shape)
    if dims_old:
        dims = [dims_old.get(i, 1) for i in (1, 2, 3, 4)]
        # squeeze caffe's legacy 4D padding for FC layers
        while len(dims) > 1 and dims[0] == 1:
            dims = dims[1:]
        try:
            return arr.reshape(dims)
        except ValueError:
            return arr
    return arr


def _parse_layer(buf, name_field, blobs_field):
    name = None
    blobs = []
    for field, wire, val in iter_fields(buf):
        if field == name_field and wire == 2:
            name = val.decode("utf-8", "replace")
        elif field == blobs_field and wire == 2:
            blobs.append(_parse_blob(val))
    return name, blobs


def read_caffemodel(path):
    """Returns {layer_name: [blob arrays]} from a .caffemodel file."""
    with open(path, "rb") as f:
        buf = f.read()
    layers = {}
    for field, wire, val in iter_fields(buf):
        if wire != 2:
            continue
        if field == 2:       # V1LayerParameter
            name, blobs = _parse_layer(val, name_field=4, blobs_field=6)
        elif field == 100:   # LayerParameter
            name, blobs = _parse_layer(val, name_field=1, blobs_field=7)
        else:
            continue
        if name and blobs:
            layers[name] = blobs
    return layers


def _named_param_modules(model):
    out = {}

    def visit(m):
        name = getattr(m, "name", None)
        if m._parameters and name:
            out[name] = m
        for c in m._modules.values():
            visit(c)

    visit(model)
    return out


def read_prototxt(path):
    """Parse a net .prototxt (protobuf TEXT format) minimally: returns
    [{"name": ..., "type": ...}] for every layer/layers block, in order
    (the deploy-net side of ref CaffeLoader.scala:40 — loadCaffe takes
    defPath + modelPath and matches against the *definition*)."""
    with open(path) as f:
        text = f.read()
    layers = []
    i, n = 0, len(text)
    import re
    block_re = re.compile(r"\b(layer|layers)\s*\{")
    kv_re = re.compile(r'\b(name|type)\s*:\s*(?:"([^"]*)"|(\w+))')
    for m in block_re.finditer(text):
        # find the matching close brace of this block
        depth, j = 1, m.end()
        while j < n and depth:
            if text[j] == "{":
                depth += 1
            elif text[j] == "}":
                depth -= 1
            j += 1
        body = text[m.end():j - 1]
        # only top-level keys of the block (strip nested {...} bodies)
        flat, d = [], 0
        for ch in body:
            if ch == "{":
                d += 1
            elif ch == "}":
                d -= 1
            elif d == 0:
                flat.append(ch)
        entry = {}
        for key, quoted, bare in kv_re.findall("".join(flat)):
            entry.setdefault(key, quoted or bare)
        if "name" in entry:
            layers.append(entry)
    return layers


def load(model, caffemodel_path, prototxt_path=None, match_all: bool = True):
    """Copy caffemodel weights onto ``model`` by layer name
    (ref CaffeLoader.load :155; name matching :127).

    ``prototxt_path``: when given, the net definition's layer list is the
    contract — named model modules missing from the prototxt raise (they
    could never be filled), like the reference's defPath-driven matching.
    Blob shapes are always cross-validated: a blob whose element count
    differs from the destination parameter raises with both shapes, never
    a silent mis-reshape; benign layout differences (e.g. Caffe's
    (1,1,out,in) InnerProduct blobs) are reshaped."""
    import torch

    blobs_by_name = read_caffemodel(caffemodel_path)
    targets = _named_param_modules(model)
    if prototxt_path is not None:
        proto_names = {l["name"] for l in read_prototxt(prototxt_path)}
        unknown = set(targets) - proto_names
        if unknown:
            raise ValueError(
                "model modules %s are not layers of %s (prototxt layers: "
                "%s...)" % (sorted(unknown), prototxt_path,
                            sorted(proto_names)[:10]))
    copied = set()
    for name, module in targets.items():
        if name not in blobs_by_name:
            if match_all:
                raise ValueError(
                    f"module '{name}' has no blobs in the caffemodel "
                    f"(available: {sorted(blobs_by_name)[:10]}...)")
            continue
        blobs = blobs_by_name[name]
        pnames = [p for p in ("weight", "bias") if p in module._parameters]
        if len(blobs) < len(pnames):
            raise ValueError(
                f"layer '{name}': caffemodel has {len(blobs)} blobs but the "
                f"module needs {len(pnames)} ({pnames})")
        for pname, blob in zip(pnames, blobs):
            dst = module._parameters[pname]
            src = np.asarray(blob, np.float32)
            if src.size != dst.numel():
                raise ValueError(
                    f"layer '{name}' {pname}: caffemodel blob shape "
                    f"{src.shape} ({src.size} elems) does not match the "
                    f"module parameter {tuple(dst.shape)} "
                    f"({dst.numel()} elems)")
            with torch.no_grad():
                dst.copy_(torch.from_numpy(src.reshape(tuple(dst.shape))))
        copied.add(name)
    return model, copied
