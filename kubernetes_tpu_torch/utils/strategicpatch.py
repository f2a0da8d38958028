"""Strategic merge patch — the 3-way merge behind kubectl apply.

Reference: pkg/util/strategicpatch/patch.go. Operates on wire-form dicts
(what the last-applied annotation stores). Semantics:

- maps merge recursively; a key present in `original` (the last applied
  config) but absent from `modified` (the new config) was deleted by the
  user and is removed from the result; keys only the live object carries
  (server-set: status, clusterIP, nodeName, uid...) are preserved
- lists of maps with a merge key (the reference's patchMergeKey struct
  tags: containers/env/volumes by name, ports by containerPort/port,
  volumeMounts by mountPath) merge element-wise by that key with the
  same ownership rule; all other lists are replaced atomically
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

# field name -> candidate merge keys, first present in the elements wins
# (ref: the patchMergeKey tags in pkg/api/v1/types.go)
MERGE_KEYS: Dict[str, Sequence[str]] = {
    "containers": ("name",),
    "env": ("name",),
    "ports": ("containerPort", "port"),
    "volumes": ("name",),
    "volumeMounts": ("mountPath",),
    "conditions": ("type",),
    "imagePullSecrets": ("name",),
}


def _merge_key_for(field: str, *lists: Sequence[Any]) -> Optional[str]:
    for candidate in MERGE_KEYS.get(field, ()):
        for lst in lists:
            for el in lst:
                if isinstance(el, dict) and candidate in el:
                    return candidate
    return None


def _is_map_list(value: Any) -> bool:
    return isinstance(value, list) and \
        all(isinstance(el, dict) for el in value) and bool(value)


def merge_maps(original: Dict, modified: Dict, current: Dict) -> Dict:
    """(ref: patch.go mergeMap, three-way)"""
    out = dict(current)
    # deletions: owned by the last applied config, dropped from the new
    for key in original:
        if key not in modified and key in out:
            del out[key]
    for key, mval in modified.items():
        oval = original.get(key)
        cval = out.get(key)
        if isinstance(mval, dict) and isinstance(cval, dict):
            out[key] = merge_maps(oval if isinstance(oval, dict) else {},
                                  mval, cval)
        elif (_is_map_list(mval) or _is_map_list(cval)) and \
                isinstance(mval, list) and isinstance(cval, list):
            out[key] = _merge_lists(
                key, oval if isinstance(oval, list) else [], mval, cval)
        else:
            out[key] = mval
    return out


def _merge_lists(field: str, original: List, modified: List,
                 current: List) -> List:
    """(ref: patch.go mergeSlice — patchMergeKey lists merge by element,
    the rest replace)"""
    mk = _merge_key_for(field, original, modified, current)
    if mk is None:
        return list(modified)
    cur_by = {el[mk]: el for el in current
              if isinstance(el, dict) and mk in el}
    orig_keys = {el[mk] for el in original
                 if isinstance(el, dict) and mk in el}
    orig_by = {el[mk]: el for el in original
               if isinstance(el, dict) and mk in el}
    out: List = []
    mod_keys = set()
    for el in modified:
        if not isinstance(el, dict) or mk not in el:
            out.append(el)
            continue
        k = el[mk]
        mod_keys.add(k)
        if k in cur_by:
            out.append(merge_maps(orig_by.get(k, {}), el, cur_by[k]))
        else:
            out.append(el)
    # elements only the live object has: server-set (or another owner's)
    # unless the last applied config owned them — then they're deletions
    for el in current:
        if not isinstance(el, dict) or mk not in el:
            continue
        k = el[mk]
        if k not in mod_keys and k not in orig_keys:
            out.append(el)
    return out


_DIRECTIVE = "$patch"  # patch.go directiveMarker


def strategic_patch(current: Dict, patch: Dict) -> Dict:
    """Two-way strategic merge — the apiserver's PATCH with
    application/strategic-merge-patch+json (ref: resthandler.go
    patchResource -> strategicpatch.StrategicMergePatch): explicit
    nulls delete, maps recurse, patchMergeKey lists merge by element,
    other lists replace wholesale. The patch.go directives are
    honored: a map carrying `"$patch": "replace"` replaces instead of
    merging, a map carrying `"$patch": "delete"` empties it (the
    reference's mergeMap returns an empty map), a keyed list element
    carrying `"$patch": "delete"` removes its counterpart, and any
    OTHER directive value raises ValueError (mergeMap's "Unknown patch
    type" error — the apiserver surfaces it as a 400); directive
    markers never persist."""
    directive = patch.get(_DIRECTIVE)
    if directive == "replace":
        return {k: v for k, v in patch.items() if k != _DIRECTIVE}
    if directive == "delete":
        return {}
    if directive is not None:
        raise ValueError(
            f"unknown patch type: {directive!r} in map {patch!r}")
    out = dict(current)
    for key, pval in patch.items():
        if key == _DIRECTIVE:
            continue
        if pval is None:
            out.pop(key, None)
            continue
        cval = out.get(key)
        if isinstance(pval, dict):
            # merge against {} when the live key is absent/non-map so
            # directive markers strip either way
            out[key] = strategic_patch(
                cval if isinstance(cval, dict) else {}, pval)
        elif isinstance(pval, list) and _is_map_list(pval):
            # merge against [] when the live key is absent/non-list so
            # $patch markers strip either way
            out[key] = _merge_lists_two_way(
                key, pval, cval if isinstance(cval, list) else [])
        elif isinstance(pval, list) and isinstance(cval, list) \
                and _is_map_list(cval):
            out[key] = _merge_lists_two_way(key, pval, cval)
        else:
            out[key] = pval
    return out


def _strip_directives(el: Any) -> Any:
    if isinstance(el, dict):
        return {k: v for k, v in el.items() if k != _DIRECTIVE}
    return el


def _merge_lists_two_way(field: str, patch_list: List,
                         current: List) -> List:
    # a standalone {"$patch": "replace"} element (patch.go's
    # replace-list directive): the remaining elements ARE the new list
    if any(isinstance(el, dict) and el.get(_DIRECTIVE) == "replace"
           for el in patch_list):
        # the remaining (marker-stripped) elements ARE the new list;
        # the standalone {"$patch": "replace"} element itself drops
        return [_strip_directives(el) for el in patch_list
                if not (isinstance(el, dict)
                        and el.get(_DIRECTIVE) == "replace"
                        and len(el) == 1)]
    mk = _merge_key_for(field, patch_list, current)
    if mk is None or any(not isinstance(el, dict) or mk not in el
                         for el in patch_list):
        # unkeyed patch elements: replace (markers never persist)
        return [_strip_directives(el) for el in patch_list]
    deletes = {el[mk] for el in patch_list
               if el.get(_DIRECTIVE) == "delete"}
    patch_by = {el[mk]: el for el in patch_list
                if el[mk] not in deletes}
    out: List = []
    seen = set()
    for el in current:
        k = el.get(mk) if isinstance(el, dict) else None
        if k in deletes:
            continue  # "$patch": "delete" removes the counterpart
        if k in patch_by:
            seen.add(k)
            out.append(strategic_patch(el, patch_by[k]))
        else:
            out.append(el)
    for el in patch_list:
        if el[mk] not in seen and el[mk] not in deletes:
            out.append({k: v for k, v in el.items() if k != _DIRECTIVE})
    return out


def json_merge_patch(current: Any, patch: Any) -> Any:
    """RFC 7386 merge patch — application/merge-patch+json: null
    deletes, objects merge recursively, everything else (lists
    included) replaces."""
    if not isinstance(patch, dict):
        return patch
    out = dict(current) if isinstance(current, dict) else {}
    for k, v in patch.items():
        if v is None:
            out.pop(k, None)
        else:
            out[k] = json_merge_patch(out.get(k), v)
    return out


def _list_index(token: str) -> int:
    """RFC 6901 array token: non-negative digits, no leading zeros
    (negative Python indexing would silently target the wrong
    element)."""
    if not token.isdigit() or (len(token) > 1 and token[0] == "0"):
        raise ValueError(f"invalid array index {token!r}")
    return int(token)


def _pointer_walk(doc: Any, pointer: str):
    """RFC 6901: -> (parent, final token). '' addresses the root
    (parent None)."""
    if pointer == "":
        return None, None
    if not pointer.startswith("/"):
        raise ValueError(f"invalid JSON pointer {pointer!r}")
    tokens = [t.replace("~1", "/").replace("~0", "~")
              for t in pointer[1:].split("/")]
    cur = doc
    for t in tokens[:-1]:
        if isinstance(cur, list):
            cur = cur[_list_index(t)]
        elif isinstance(cur, dict):
            cur = cur[t]
        else:
            raise ValueError(f"pointer {pointer!r}: cannot traverse "
                             f"{type(cur).__name__}")
    return cur, tokens[-1]


def apply_json_patch(doc: Any, ops: List[Dict]) -> Any:
    """RFC 6902 — application/json-patch+json: add / remove / replace /
    move / copy / test over JSON pointers. Operates on (and returns) a
    deep copy; a failed `test` or bad pointer raises ValueError."""
    import copy
    import json as _json
    doc = copy.deepcopy(doc)
    for op in ops:
        if not isinstance(op, dict) or "path" not in op:
            raise ValueError("json-patch op missing required 'path'")
        kind = op.get("op")
        parent, tok = _pointer_walk(doc, op["path"])

        def _get(p, t):
            if isinstance(p, list):
                return p[_list_index(t)]
            if isinstance(p, dict):
                return p[t]
            raise ValueError(
                f"cannot index into {type(p).__name__} with {t!r}")

        if kind == "add":
            val = op["value"]
            if parent is None:
                doc = val
            elif isinstance(parent, list):
                i = len(parent) if tok == "-" else _list_index(tok)
                if i > len(parent):  # RFC 6902: > length is an error
                    raise ValueError(
                        f"add: index {i} beyond array length")
                parent.insert(i, val)
            else:
                parent[tok] = val
        elif kind == "remove":
            if parent is None:
                raise ValueError("cannot remove the root")
            if isinstance(parent, list):
                del parent[_list_index(tok)]
            else:
                del parent[tok]
        elif kind == "replace":
            if parent is None:
                doc = op["value"]
            elif isinstance(parent, list):
                parent[_list_index(tok)] = op["value"]
            else:
                if tok not in parent:
                    raise ValueError(f"replace: no member {tok!r}")
                parent[tok] = op["value"]
        elif kind in ("move", "copy"):
            src_parent, src_tok = _pointer_walk(doc, op["from"])
            val = doc if src_parent is None else _get(src_parent, src_tok)
            val = copy.deepcopy(val)
            if kind == "move":
                if isinstance(src_parent, list):
                    del src_parent[_list_index(src_tok)]
                elif src_parent is not None:
                    del src_parent[src_tok]
            # re-resolve: a move may have shifted list indices
            parent, tok = _pointer_walk(doc, op["path"])
            if parent is None:
                doc = val
            elif isinstance(parent, list):
                i = len(parent) if tok == "-" else _list_index(tok)
                if i > len(parent):  # RFC 6902: > length is an error
                    raise ValueError(
                        f"{kind}: index {i} beyond array length")
                parent.insert(i, val)
            else:
                parent[tok] = val
        elif kind == "test":
            have = doc if parent is None else _get(parent, tok)
            if _json.dumps(have, sort_keys=True) != \
                    _json.dumps(op["value"], sort_keys=True):
                raise ValueError(f"test failed at {op.get('path')!r}")
        else:
            raise ValueError(f"unknown json-patch op {kind!r}")
    return doc


def three_way_merge(original: Dict, modified: Dict,
                    current: Dict) -> Dict:
    """kubectl apply's patch: original = last applied config, modified =
    the new config, current = the live object. Returns the object to
    write back: the user's intent applied over the live state with
    server-set fields intact (ref: patch.go CreateThreeWayMergePatch +
    StrategicMergePatch, fused — we write the merged object, not a
    patch document)."""
    return merge_maps(original or {}, modified or {}, current or {})
