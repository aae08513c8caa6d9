"""wire-contract: one-sided wire edits fail lint, not a Sync frame.

The BatchedScorer seam has codecs on both sides that must agree
byte-for-byte: ``koordinator_tpu/bridge/scorer.proto`` (the contract,
read here as text), the hand-rolled Go protowire codec in
``go/scorerclient/wire.go`` + ``delta.go``, the port's codec
``koordinator_tpu_torch/bridge/wire.py`` and the port's independent
mirror ``koordinator_tpu_torch/bridge/wirecheck.py``.  The runtime tests
can only exercise the Python pair (no Go toolchain in the image), so the
Go half is checked STATICALLY here: the marshal/unmarshal functions are
parsed out of the Go source and diffed against the proto —

* field names (snake_case -> CamelCase, ``_id`` -> ``ID``),
* field numbers and emit ORDER (ascending order is what makes the
  marshaling byte-stable against the Python side),
* integer widths (proto int32/int64 -> appendPackedInt32/Int64 etc.),
* endianness helpers for the packed little-endian byte payloads
  (``// i32 LE`` / ``i64 LE`` annotations in the proto are the spec),
* the shared delta-encoding constant (delta.go DefaultMaxDeltaRatio
  must equal state.py numpy_to_tensor's default max_delta_ratio),

plus a static diff of every message class of the port's codec
(``bridge/wire.py`` ``FIELDS`` tables: names, numbers, kinds, wire types,
packedness) against the .proto in both directions — the port's codec
stands where the reference's generated ``scorer_pb2`` stands — and of
the replication frame table (``replication/codec.py``) against the
mirror's and replica.go's.  All functions take source TEXT so tests can
seed one-sided regressions.
"""

from __future__ import annotations

import ast
import dataclasses
import os
import re
from typing import Dict, List, Optional, Tuple

from koordinator_tpu_torch.analysis.core import Violation

RULE = "wire-contract"

PROTO_PATH = "koordinator_tpu/bridge/scorer.proto"
WIRE_PY_PATH = "koordinator_tpu_torch/bridge/wire.py"
WIRECHECK_PATH = "koordinator_tpu_torch/bridge/wirecheck.py"
STATE_PATH = "koordinator_tpu_torch/bridge/state.py"
CODEC_PATH = "koordinator_tpu_torch/replication/codec.py"

_SCALARS = {"int32", "int64", "uint32", "uint64", "bool", "string",
            "bytes", "double", "float", "sint32", "sint64", "fixed32",
            "fixed64"}

# proto (type, repeated) -> the wire.go append helper that emits it
_EXPECTED_HELPER = {
    ("int64", True): "appendPackedInt64",
    ("int64", False): "appendVarintField",
    ("int32", True): "appendPackedInt32",
    ("bool", True): "appendPackedBools",
    ("bool", False): "appendVarintField",
    ("string", True): "appendRepeatedString",
    ("string", False): "appendStringField",
    ("bytes", False): "appendBytesField",
}

# reply fields the Go client deliberately does not decode
_ALLOWED_UNDECODED = {("ScoreReply", 1)}  # legacy per-pod lists; Go is flat-only


@dataclasses.dataclass
class ProtoField:
    num: int
    name: str
    ptype: str
    repeated: bool
    le_width: Optional[int]  # 32/64 from an "iNN LE" comment annotation

    @property
    def is_message(self) -> bool:
        return self.ptype not in _SCALARS


def camel(snake: str) -> str:
    return "".join(
        "ID" if seg == "id" else seg.capitalize()
        for seg in snake.split("_")
    )


# ---- parsers ----

_MSG_RE = re.compile(r"^message\s+(\w+)\s*\{", re.M)
_FIELD_RE = re.compile(
    r"^\s*(repeated\s+)?(\w+)\s+(\w+)\s*=\s*(\d+)\s*;(.*)$"
)
# inline form allows several fields on the message's own line (the empty
# 5th group keeps _field_of's comment-annotation slot aligned)
_FIELD_INLINE_RE = re.compile(
    r"(repeated\s+)?(\w+)\s+(\w+)\s*=\s*(\d+)\s*;()"
)
_LE_RE = re.compile(r"i(32|64)\s+LE")


def parse_proto(text: str) -> Dict[str, List[ProtoField]]:
    out: Dict[str, List[ProtoField]] = {}
    current: Optional[str] = None
    for line in text.splitlines():
        m = _MSG_RE.match(line.strip())
        if m:
            current = m.group(1)
            out[current] = []
            # single-line message: "message GangTable { repeated ... }"
            rest = line.split("{", 1)[1]
            for fm in _FIELD_INLINE_RE.finditer(rest):
                out[current].append(_field_of(fm))
            if "}" in rest:
                current = None
            continue
        if current is None:
            continue
        if line.strip().startswith("}"):
            current = None
            continue
        fm = _FIELD_RE.match(line)
        if fm:
            out[current].append(_field_of(fm))
    return out


def _field_of(m: "re.Match") -> ProtoField:
    trail = m.group(5) or ""
    le = _LE_RE.search(trail)
    return ProtoField(
        num=int(m.group(4)),
        name=m.group(3),
        ptype=m.group(2),
        repeated=bool(m.group(1)),
        le_width=int(le.group(1)) if le else None,
    )


@dataclasses.dataclass
class GoEmit:
    num: int
    helper: str
    field: Optional[str]  # receiver field name the value came from
    line: int


_GO_MARSHAL_HEAD = re.compile(
    r"^func \((\w+) \*(\w+)\) [Mm]arshal\(\) \[\]byte \{"
)
_GO_RANGE = re.compile(r"for\s+\w+,\s*(\w+)\s*:=\s*range\s+(\w+)\.(\w+)")
_GO_GUARD = re.compile(r"if\s+(\w+)\.(\w+)\s*\{")
_GO_EMIT = re.compile(r"=\s*(append\w+)\(b,\s*(\d+),\s*(.+)\)\s*(?://.*)?$")


def parse_go_marshals(text: str) -> Dict[str, List[GoEmit]]:
    """struct name -> ordered field emissions of its marshal function."""
    out: Dict[str, List[GoEmit]] = {}
    recv = struct = None
    loop_fields: Dict[str, str] = {}
    guard_field: Optional[str] = None
    for lineno, line in enumerate(text.splitlines(), start=1):
        head = _GO_MARSHAL_HEAD.match(line)
        if head:
            recv, struct = head.group(1), head.group(2)
            out[struct] = []
            loop_fields = {}
            guard_field = None
            continue
        if struct is None:
            continue
        if line.startswith("}"):
            recv = struct = None
            continue
        if line.strip() == "}":
            guard_field = None  # inner block closed: the guard is over
            continue
        rng = _GO_RANGE.search(line)
        if rng and rng.group(2) == recv:
            loop_fields[rng.group(1)] = rng.group(3)
        grd = _GO_GUARD.search(line)
        if grd and grd.group(1) == recv:
            guard_field = grd.group(2)
        emit = _GO_EMIT.search(line)
        if not emit:
            continue
        helper, num, expr = emit.group(1), int(emit.group(2)), emit.group(3)
        field: Optional[str] = None
        fm = re.match(rf"{recv}\.(\w+)", expr)
        if fm:
            field = fm.group(1)
        elif expr in loop_fields:
            field = loop_fields[expr]
        elif guard_field is not None:
            # e.g. `if r.Flat { appendVarintField(b, 3, 1) }` — consume
            # the guard so a later local-variable emit is not
            # mis-attributed to it
            field = guard_field
            guard_field = None
        out[struct].append(GoEmit(num, helper, field, lineno))
    return out


_GO_UNMARSHAL_HEAD = re.compile(r"^func Unmarshal(\w+)\(b \[\]byte\)")
_GO_CASE = re.compile(r"^\s*case\s+(\d+):")
_GO_ASSIGN = re.compile(r"r\.((?:Flat\.)?\w+)(?:\s*=|\s*=\s*append\()")
_GO_LE_HELPER = re.compile(r"=\s*(le\w+|string|float64FromBits|packedInt32)")


def parse_go_unmarshals(text: str) -> Dict[str, List[Tuple[int, str, str, int]]]:
    """Unmarshal functions -> [(case_num, assigned_field, helper, line)].
    Nested switches (FlatScores inside ScoreReply) associate with the
    nearest preceding ``case N:`` — assignments to ``Flat.X`` carry the
    inner field number."""
    out: Dict[str, List[Tuple[int, str, str, int]]] = {}
    current: Optional[str] = None
    last_case = -1
    for lineno, line in enumerate(text.splitlines(), start=1):
        head = _GO_UNMARSHAL_HEAD.match(line)
        if head:
            current = head.group(1)
            out[current] = []
            last_case = -1
            continue
        if current is None:
            continue
        if line.startswith("}"):
            current = None
            continue
        cm = _GO_CASE.match(line)
        if cm:
            last_case = int(cm.group(1))
            continue
        am = _GO_ASSIGN.search(line)
        if am and last_case >= 0:
            hm = _GO_LE_HELPER.search(line)
            helper = hm.group(1) if hm else ""
            out[current].append((last_case, am.group(1), helper, lineno))
    return out


# ---- the diff ----

def diff_proto_go(
    proto_text: str,
    wire_go_text: str,
    go_path: str = "go/scorerclient/wire.go",
) -> List[Violation]:
    proto = parse_proto(proto_text)
    marshals = parse_go_marshals(wire_go_text)
    unmarshals = parse_go_unmarshals(wire_go_text)
    out: List[Violation] = []

    def v(line: int, msg: str) -> None:
        out.append(Violation(rule=RULE, path=go_path, line=line, message=msg))

    # -- marshal side: Go -> Python requests --
    for struct, emits in marshals.items():
        fields = proto.get(struct)
        if fields is None:
            v(emits[0].line if emits else 0,
              f"Go struct {struct} has a marshal but no proto message")
            continue
        by_num = {f.num: f for f in fields}
        nums = [e.num for e in emits]
        if nums != sorted(nums):
            v(emits[0].line,
              f"{struct}.marshal emits fields out of ascending order "
              f"({nums}): byte-stability against the Python runtime "
              "requires ascending field numbers")
        seen = set()
        for e in emits:
            seen.add(e.num)
            f = by_num.get(e.num)
            if f is None:
                v(e.line,
                  f"{struct}.marshal emits field {e.num} which does not "
                  f"exist in proto message {struct}")
                continue
            want_name = camel(f.name)
            if e.field is not None and e.field != want_name:
                v(e.line,
                  f"{struct}.marshal field {e.num}: Go emits {e.field!r} "
                  f"but proto field {e.num} is '{f.name}' "
                  f"(expected Go field {want_name})")
            if f.is_message:
                if e.helper != "appendMessage":
                    v(e.line,
                      f"{struct}.{want_name} (field {e.num}) is a message "
                      f"({f.ptype}) but is emitted with {e.helper}")
            else:
                want_helper = _EXPECTED_HELPER.get((f.ptype, f.repeated))
                if want_helper and e.helper != want_helper:
                    v(e.line,
                      f"{struct}.{want_name} (field {e.num}, "
                      f"{'repeated ' if f.repeated else ''}{f.ptype}) "
                      f"emitted with {e.helper}; width/kind contract "
                      f"expects {want_helper}")
        for f in fields:
            if f.num not in seen:
                v(0,
                  f"{struct}.marshal never emits proto field {f.num} "
                  f"('{f.name}'): a populated value would be dropped "
                  "from the wire")

    # -- unmarshal side: Python replies -> Go --
    for msg, cases in unmarshals.items():
        fields = proto.get(msg)
        if fields is None:
            continue
        flat_fields = proto.get("FlatScores", [])
        flat_by_num = {f.num: f for f in flat_fields}
        by_num = {f.num: f for f in fields}
        decoded = set()
        for num, assigned, helper, line in cases:
            if assigned.startswith("Flat."):
                f = flat_by_num.get(num)
                scope, name = "FlatScores", assigned[len("Flat."):]
            else:
                f = by_num.get(num)
                scope, name = msg, assigned
                decoded.add(num)
            if name == "HasFlat":
                continue  # presence marker, not a wire field
            if f is None:
                v(line,
                  f"Unmarshal{msg} decodes field {num} into {assigned} "
                  f"but proto message {scope} has no field {num}")
                continue
            want_name = camel(f.name)
            if name != want_name:
                v(line,
                  f"Unmarshal{msg} field {num}: Go assigns {assigned!r} "
                  f"but proto field {num} is '{f.name}' "
                  f"(expected {want_name})")
            if f.le_width and helper and helper != f"leInt{f.le_width}s":
                v(line,
                  f"{scope}.{f.name} is annotated i{f.le_width} LE but "
                  f"Unmarshal{msg} decodes it with {helper}; wrong width "
                  "or endianness silently corrupts the payload")
        for f in fields:
            if f.num not in decoded and (msg, f.num) not in _ALLOWED_UNDECODED:
                v(0,
                  f"Unmarshal{msg} never decodes proto field {f.num} "
                  f"('{f.name}')")
    return out


# ---- the independent mirror: bridge/wirecheck.py message decoders ----
# The runtime golden round-trips exercise wirecheck against the codec,
# but only for field values the fixtures happen to populate — a decoder
# branch MISSING for a new field (a deadline, band or degraded flag, say)
# silently drops the value instead of failing a test.  This check parses the hand-rolled
# ``if field == N: r["name"] = ...`` walks out of wirecheck.py via AST
# and diffs them against the proto: every scalar field must have a
# branch, under its proto name, at its proto number.

_WIRECHECK_DECODERS = {
    "ScoreRequest": "decode_score_request",
    "AssignRequest": "decode_assign_request",
    "ScoreReply": "decode_score_reply",
    "SyncReply": "decode_sync_reply",
    "AssignReply": "decode_assign_reply",
}


def _branch_field_keys(fn: ast.FunctionDef):
    """[(field_num, {r-subscript keys used in the branch}, line)] for
    every ``if field == <const>`` branch in a wirecheck decoder."""
    out = []
    for node in ast.walk(fn):
        if not isinstance(node, ast.If):
            continue
        test = node.test
        if not (
            isinstance(test, ast.Compare)
            and isinstance(test.left, ast.Name)
            and test.left.id == "field"
            and len(test.comparators) == 1
            and isinstance(test.comparators[0], ast.Constant)
            and isinstance(test.comparators[0].value, int)
        ):
            continue
        num = int(test.comparators[0].value)
        keys = set()
        for sub in node.body:
            for n in ast.walk(sub):
                if (
                    isinstance(n, ast.Subscript)
                    and isinstance(n.value, ast.Name)
                    and n.value.id == "r"
                    and isinstance(n.slice, ast.Constant)
                    and isinstance(n.slice.value, str)
                ):
                    keys.add(n.slice.value)
        out.append((num, keys, node.lineno))
    return out


def check_wirecheck_messages(
    proto_text: str,
    wirecheck_text: str,
    path: str = WIRECHECK_PATH,
) -> List[Violation]:
    proto = parse_proto(proto_text)
    out: List[Violation] = []
    try:
        tree = ast.parse(wirecheck_text)
    except SyntaxError:
        return out  # the AST rules already report a parse error
    funcs = {
        n.name: n for n in ast.walk(tree)
        if isinstance(n, ast.FunctionDef)
    }
    for msg, fname in _WIRECHECK_DECODERS.items():
        fields = proto.get(msg)
        if fields is None:
            continue
        fn = funcs.get(fname)
        if fn is None:
            out.append(Violation(
                RULE, path, 0,
                f"wirecheck.py decoder {fname} for proto message "
                f"{msg} not found (the independent mirror lost a "
                "message)",
            ))
            continue
        branches = _branch_field_keys(fn)
        by_num = {num: (keys, line) for num, keys, line in branches}
        for f in fields:
            got = by_num.get(f.num)
            if got is None:
                out.append(Violation(
                    RULE, path, fn.lineno,
                    f"{fname} has no 'field == {f.num}' branch: proto "
                    f"{msg}.{f.name} would be silently dropped by the "
                    "wirecheck mirror",
                ))
                continue
            keys, line = got
            # message-typed fields decode into nested dicts whose key
            # usually matches; scalar fields MUST land under the proto
            # name so the two mirrors stay diffable
            if keys and f.name not in keys:
                out.append(Violation(
                    RULE, path, line,
                    f"{fname} field {f.num} writes {sorted(keys)} but "
                    f"proto {msg} field {f.num} is '{f.name}'",
                ))
        for num, _keys, line in branches:
            if num not in {f.num for f in fields}:
                out.append(Violation(
                    RULE, path, line,
                    f"{fname} decodes field {num} which does not exist "
                    f"in proto message {msg}",
                ))
    return out


_GO_RATIO = re.compile(r"DefaultMaxDeltaRatio\s*=\s*([0-9.]+)")


def python_delta_ratio_default(state_py_text: str) -> Optional[float]:
    """state.py numpy_to_tensor's max_delta_ratio default, via AST."""
    tree = ast.parse(state_py_text)
    for node in ast.walk(tree):
        if isinstance(node, ast.FunctionDef) and node.name == "numpy_to_tensor":
            args = node.args
            defaults = dict(
                zip([a.arg for a in args.args][-len(args.defaults):],
                    args.defaults)
            ) if args.defaults else {}
            d = defaults.get("max_delta_ratio")
            if isinstance(d, ast.Constant) and isinstance(d.value, (int, float)):
                return float(d.value)
    return None


def check_delta_constants(
    delta_go_text: str,
    state_py_text: str,
    go_path: str = "go/scorerclient/delta.go",
) -> List[Violation]:
    out: List[Violation] = []
    m = _GO_RATIO.search(delta_go_text)
    py = python_delta_ratio_default(state_py_text)
    if m is None:
        out.append(Violation(RULE, go_path, 0,
                             "DefaultMaxDeltaRatio constant not found"))
    elif py is not None and abs(float(m.group(1)) - py) > 1e-12:
        line = delta_go_text[: m.start()].count("\n") + 1
        out.append(Violation(
            RULE, go_path, line,
            f"DefaultMaxDeltaRatio={m.group(1)} but bridge/state.py "
            f"numpy_to_tensor defaults max_delta_ratio={py}: the two "
            "sides would disagree on when a delta frame is worth it",
        ))
    for field in ("DeltaIdx", "DeltaVal"):
        if not re.search(rf"t\.{field}\s*=\s*LEInt64Bytes\(", delta_go_text):
            out.append(Violation(
                RULE, go_path, 0,
                f"DeltaTensor does not pack {field} with LEInt64Bytes: "
                "delta payloads are little-endian int64 by contract "
                "(state.py decode_tensor np.frombuffer '<i8')",
            ))
    return out


# ---- replication stream framing ----
# Three statements of the leader->follower frame header must agree:
# the port's replication/codec.py FRAME_FIELDS (the layout's home),
# its bridge/wirecheck.py REPLICA_FRAME_FIELDS (the independent runtime
# mirror), and go/scorerclient/replica.go replicaFrameFields.  Same
# treatment as scorer.proto vs wire.go: field names, emit order, byte
# widths, and the magic/version constants, diffed statically so a
# one-sided framing edit fails lint before any frame is built.

_GO_FRAME_ENTRY = re.compile(r'\{"(\w+)",\s*(\d+)\}')
_GO_FRAME_CONST = re.compile(
    r"(ReplicaFrameMagic|ReplicaFrameVersion|ReplicaHeaderLen)\s*=\s*"
    r"(0[xX][0-9a-fA-F]+|\d+)"
)


def _parse_py_frame_table(text: str, table_name: str, consts: Tuple[str, ...]):
    """(fields, constants, line-of-table) from a Python source: the
    ``table_name`` tuple-of-(name, width) assignment plus the named
    integer constants, via AST."""
    fields: List[Tuple[str, int]] = []
    values: Dict[str, int] = {}
    line = 0
    tree = ast.parse(text)
    for node in ast.walk(tree):
        if not isinstance(node, ast.Assign) or len(node.targets) != 1:
            continue
        target = node.targets[0]
        if not isinstance(target, ast.Name):
            continue
        if target.id == table_name and isinstance(
            node.value, (ast.Tuple, ast.List)
        ):
            line = node.lineno
            for elt in node.value.elts:
                if (
                    isinstance(elt, (ast.Tuple, ast.List))
                    and len(elt.elts) == 2
                    and isinstance(elt.elts[0], ast.Constant)
                    and isinstance(elt.elts[1], ast.Constant)
                ):
                    fields.append(
                        (str(elt.elts[0].value), int(elt.elts[1].value))
                    )
        elif target.id in consts and isinstance(node.value, ast.Constant):
            if isinstance(node.value.value, int):
                values[target.id] = int(node.value.value)
    return fields, values, line


def _parse_go_frame_table(text: str):
    """(fields, constants, line-of-table) from replica.go: the
    replicaFrameFields literal entries in order plus the frame
    constants."""
    fields: List[Tuple[str, int]] = []
    line = 0
    in_table = False
    for lineno, src in enumerate(text.splitlines(), start=1):
        if "replicaFrameFields" in src and "=" in src:
            in_table = True
            line = lineno
            continue
        if in_table:
            m = _GO_FRAME_ENTRY.search(src)
            if m:
                fields.append((m.group(1), int(m.group(2))))
            elif src.strip() == "}":
                in_table = False
    consts = {
        m.group(1): int(m.group(2), 0)
        for m in _GO_FRAME_CONST.finditer(text)
    }
    return fields, consts, line


def check_replication_framing(
    codec_text: str,
    wirecheck_text: str,
    replica_go_text: str,
    go_path: str = "go/scorerclient/replica.go",
) -> List[Violation]:
    out: List[Violation] = []
    spec, spec_consts, _ = _parse_py_frame_table(
        codec_text, "FRAME_FIELDS", ("MAGIC", "VERSION")
    )
    mirror, mirror_consts, mirror_line = _parse_py_frame_table(
        wirecheck_text, "REPLICA_FRAME_FIELDS",
        ("REPLICA_MAGIC", "REPLICA_VERSION"),
    )
    go_fields, go_consts, go_line = _parse_go_frame_table(replica_go_text)
    if not spec:
        out.append(Violation(
            RULE, CODEC_PATH, 0,
            "FRAME_FIELDS table not found: the replication frame "
            "layout has lost its one canonical Python statement",
        ))
        return out

    def diff_table(got, got_path, got_line, label):
        if got != spec:
            out.append(Violation(
                RULE, got_path, got_line,
                f"{label} frame table {got} disagrees with "
                f"replication/codec.py FRAME_FIELDS {spec}: a follower "
                "decoding with one layout while the leader emits the "
                "other tears every frame on the stream",
            ))

    if not mirror:
        out.append(Violation(
            RULE, WIRECHECK_PATH, 0,
            "REPLICA_FRAME_FIELDS mirror table not found in "
            "wirecheck.py (the independent second implementation)",
        ))
    else:
        diff_table(mirror, WIRECHECK_PATH,
                   mirror_line, "wirecheck.py REPLICA_FRAME_FIELDS")
    if not go_fields:
        out.append(Violation(
            RULE, go_path, 0,
            "replicaFrameFields table not found in replica.go",
        ))
    else:
        diff_table(go_fields, go_path, go_line,
                   "replica.go replicaFrameFields")
    # constants: magic + version must agree on all three sides, and the
    # Go header-length constant must equal the table's width sum
    pairs = (
        ("MAGIC", spec_consts.get("MAGIC"),
         mirror_consts.get("REPLICA_MAGIC"),
         go_consts.get("ReplicaFrameMagic")),
        ("VERSION", spec_consts.get("VERSION"),
         mirror_consts.get("REPLICA_VERSION"),
         go_consts.get("ReplicaFrameVersion")),
    )
    for name, spec_v, mirror_v, go_v in pairs:
        if mirror_v is not None and mirror_v != spec_v:
            out.append(Violation(
                RULE, WIRECHECK_PATH, 0,
                f"replica frame {name}: wirecheck.py says "
                f"{mirror_v:#x} but codec.py says {spec_v:#x}"
                if spec_v is not None else
                f"replica frame {name} missing from codec.py",
            ))
        if go_v is not None and go_v != spec_v:
            out.append(Violation(
                RULE, go_path, 0,
                f"replica frame {name}: replica.go says {go_v:#x} "
                f"but codec.py says "
                f"{spec_v:#x}" if spec_v is not None else
                f"replica frame {name} missing from codec.py",
            ))
    want_len = sum(w for _, w in spec)
    go_len = go_consts.get("ReplicaHeaderLen")
    if go_len is not None and go_len != want_len:
        out.append(Violation(
            RULE, go_path, 0,
            f"ReplicaHeaderLen={go_len} but the frame table sums to "
            f"{want_len}: the Go reader would mis-frame every stream",
        ))
    return out


# ---- the port's codec: bridge/wire.py message classes ----
# Each message class of the codec declares ``FIELDS = ((number, name,
# kind, message class or None), ...)`` with ``kind`` one of the proto's
# scalar types, ``message``, or ``repeated <kind>``.  The kind fixes the
# wire type and packedness the codec writes, so diffing it against the
# proto's declaration holds both.

_WIRE_TYPE = {"int64": 0, "int32": 0, "bool": 0, "double": 1,
              "string": 2, "bytes": 2, "message": 2}
_WIRE_TYPE_NAME = {0: "varint", 1: "fixed64", 2: "length-delimited"}


def _wire_shape(kind: str) -> Tuple[int, bool]:
    """``(wire type, packed)`` of a codec kind."""
    base = kind.split()[-1]
    repeated = kind.startswith("repeated ")
    wtype = _WIRE_TYPE.get(base, 2)
    packed = repeated and wtype != 2
    return (2 if packed else wtype), packed


def _proto_kind(f: ProtoField) -> Tuple[str, Optional[str]]:
    """The codec kind a proto field must carry, and its message type."""
    base = "message" if f.is_message else f.ptype
    kind = f"repeated {base}" if f.repeated else base
    return kind, (f.ptype if f.is_message else None)


def parse_codec_messages(
    text: str,
) -> Dict[str, Tuple[int, List[Tuple[int, str, str, Optional[str], int]]]]:
    """class name -> (line, [(num, name, kind, message class, line)]) for
    every class of ``bridge/wire.py`` that assigns a ``FIELDS`` tuple."""
    out: Dict[str, Tuple[int, List[Tuple[int, str, str, Optional[str], int]]]] = {}
    tree = ast.parse(text)
    for cls in tree.body:
        if not isinstance(cls, ast.ClassDef):
            continue
        for item in cls.body:
            if not (isinstance(item, ast.Assign) and len(item.targets) == 1
                    and isinstance(item.targets[0], ast.Name)
                    and item.targets[0].id == "FIELDS"
                    and isinstance(item.value, (ast.Tuple, ast.List))):
                continue
            fields = []
            for elt in item.value.elts:
                if not (isinstance(elt, ast.Tuple) and len(elt.elts) == 4):
                    continue
                num, name, kind, sub = elt.elts
                if not (isinstance(num, ast.Constant) and isinstance(name, ast.Constant)
                        and isinstance(kind, ast.Constant)):
                    continue
                fields.append((int(num.value), str(name.value), str(kind.value),
                               sub.id if isinstance(sub, ast.Name) else None,
                               elt.lineno))
            out[cls.name] = (cls.lineno, fields)
    return out


def check_codec_messages(
    proto_text: str, wire_py_text: str, path: str = WIRE_PY_PATH,
) -> List[Violation]:
    """Every proto message has a codec class with the same fields (name,
    number, kind, wire type, packedness, message type), and every codec
    class and field exists in the proto."""
    proto = parse_proto(proto_text)
    try:
        codec = parse_codec_messages(wire_py_text)
    except SyntaxError:
        return []  # the AST rules already report a parse error
    out: List[Violation] = []
    for msg, fields in proto.items():
        if msg not in codec:
            out.append(Violation(
                RULE, path, 0,
                f"proto message {msg} has no class in the port's codec: "
                "a peer sending it could not be decoded",
            ))
            continue
        line, got = codec[msg]
        by_num = {g[0]: g for g in got}
        for f in fields:
            g = by_num.get(f.num)
            want_kind, want_sub = _proto_kind(f)
            if g is None:
                out.append(Violation(
                    RULE, path, line,
                    f"{msg}.{f.name} (field {f.num}) is missing from the "
                    "codec: its value would be dropped on decode and "
                    "never written",
                ))
                continue
            _, name, kind, sub, gline = g
            if name != f.name:
                out.append(Violation(
                    RULE, path, gline,
                    f"{msg} field {f.num} is {name!r} in the codec but "
                    f"{f.name!r} in scorer.proto",
                ))
            if kind != want_kind:
                got_w, got_p = _wire_shape(kind)
                want_w, want_p = _wire_shape(want_kind)
                out.append(Violation(
                    RULE, path, gline,
                    f"{msg}.{f.name} (field {f.num}) is {kind!r} in the "
                    f"codec but {want_kind!r} in scorer.proto (wire type "
                    f"{_WIRE_TYPE_NAME[got_w]}{' packed' if got_p else ''} "
                    f"against {_WIRE_TYPE_NAME[want_w]}"
                    f"{' packed' if want_p else ''})",
                ))
            elif want_sub is not None and sub != want_sub:
                out.append(Violation(
                    RULE, path, gline,
                    f"{msg}.{f.name} (field {f.num}) decodes into {sub} but "
                    f"scorer.proto declares {want_sub}",
                ))
        nums = {f.num for f in fields}
        for num, name, _kind, _sub, gline in got:
            if num not in nums:
                out.append(Violation(
                    RULE, path, gline,
                    f"codec {msg}.{name} (field {num}) does not exist in "
                    "scorer.proto",
                ))
    for cls, (line, _) in codec.items():
        if cls not in proto:
            out.append(Violation(
                RULE, path, line,
                f"codec class {cls} has no message in scorer.proto",
            ))
    return out


def check_repo(root: str) -> List[Violation]:
    def read(rel: str) -> Optional[str]:
        path = os.path.join(root, rel)
        if not os.path.exists(path):
            return None
        with open(path, "r", encoding="utf-8") as f:
            return f.read()

    proto = read(PROTO_PATH)
    if proto is None:
        return [Violation(RULE, PROTO_PATH, 0, "scorer.proto not found")]
    out: List[Violation] = []
    wire = read("go/scorerclient/wire.go")
    if wire is not None:
        out.extend(diff_proto_go(proto, wire))
    codec_msgs = read(WIRE_PY_PATH)
    if codec_msgs is not None:
        out.extend(check_codec_messages(proto, codec_msgs))
    wcheck = read(WIRECHECK_PATH)
    if wcheck is not None:
        out.extend(check_wirecheck_messages(proto, wcheck))
    delta = read("go/scorerclient/delta.go")
    state = read(STATE_PATH)
    if delta is not None and state is not None:
        out.extend(check_delta_constants(delta, state))
    codec = read(CODEC_PATH)
    replica = read("go/scorerclient/replica.go")
    if codec is not None and wcheck is not None and replica is not None:
        out.extend(check_replication_framing(codec, wcheck, replica))
    return out
