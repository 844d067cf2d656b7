"""Reference checkpoint payloads -> per-member generator state dicts.

Counterpart of ``councilx/ckpt/torch_convert.py::extract_member_state_dicts``.
The port's modules use the reference's MUNIT names, so a reference state
dict needs no key or layout conversion; only the payload's outer keying has
to be resolved.
"""

from __future__ import annotations


def extract_member_state_dicts(payload, direction: str):
    """Pick the per-member generator state dicts for one direction out of a
    reference checkpoint payload. Every plausible layout is handled:
    {'a2b_0': sd, ...}, {'a2b': [sd, ...]} / {'a2b': sd} (and the MUNIT-style
    short keys {'a': ...}), {'0': sd, ...}, a bare list, or a raw single
    state dict."""
    if isinstance(payload, (list, tuple)):
        return list(payload)
    if not isinstance(payload, dict):
        raise ValueError(f"unrecognized checkpoint payload: {type(payload)}")
    # raw state dict? (keys look like 'enc_content.model.0.conv.weight')
    if any("." in k for k in payload.keys()):
        return [payload]
    keys = sorted(payload.keys())
    member_keys = [k for k in keys if k.startswith(f"{direction}_")]
    if member_keys:
        return [payload[k] for k in sorted(
            member_keys, key=lambda s: int(s.rsplit("_", 1)[1]))]
    short = {"a2b": "a", "b2a": "b"}[direction]
    for cand in (direction, short):
        if cand in payload:
            inner = payload[cand]
            return (list(inner) if isinstance(inner, (list, tuple))
                    else [inner])
    if all(k.isdigit() for k in keys):
        return [payload[k] for k in sorted(keys, key=int)]
    raise ValueError(f"cannot find direction '{direction}' members among "
                     f"keys {keys}")
