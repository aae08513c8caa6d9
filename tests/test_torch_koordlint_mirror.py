"""The wirecheck mirror's and the metrics-doc drift rule's cases of
``tests/test_koordlint.py`` on both packages, through the rebinding of
``tests/test_torch_koordlint.py`` (group ``mirror``).

The port's codec (``bridge/wire.py``) against ``scorer.proto`` follows:
the port's own cases of the mirror check."""

import pytest

from koordinator_tpu_torch.analysis import wire_contract
from koordinator_tpu_torch.analysis.core import run_repo
from test_torch_constraints import PACKAGES
from test_torch_koordlint import PORT, group_cases, read, run_case

CASES = group_cases("mirror")


@pytest.mark.parametrize("package", PACKAGES)
@pytest.mark.parametrize("module,cls,method", CASES, ids=["::".join(c[1:]) for c in CASES])
def test_reference_case(module, cls, method, package, tmp_path, capsys):
    run_case(module, cls, method, package, tmp_path=tmp_path, capsys=capsys)


class TestCodecAgainstTheProto:
    """The port's codec (``bridge/wire.py``) against scorer.proto: every
    message class, field names, numbers, kinds, wire types and packedness,
    both directions."""

    @pytest.fixture(scope="class")
    def texts(self):
        return read("koordinator_tpu", "bridge", "scorer.proto"), read(PORT, "bridge", "wire.py")

    def _edit(self, text, old, new):
        assert old in text
        return text.replace(old, new)

    def test_head_is_clean(self, texts):
        assert wire_contract.check_codec_messages(*texts) == []
        parsed = wire_contract.parse_codec_messages(texts[1])
        assert set(parsed) == set(wire_contract.parse_proto(texts[0]))

    def test_a_renumbered_field_fails(self, texts):
        proto, wire = texts
        bad = self._edit(wire, '(5, "gang_id", "repeated int32", None),',
                         '(10, "gang_id", "repeated int32", None),')
        msgs = [v.message for v in wire_contract.check_codec_messages(proto, bad)]
        assert any("PodTable.gang_id (field 5) is missing" in m for m in msgs)
        assert any("codec PodTable.gang_id (field 10) does not exist" in m for m in msgs)

    def test_a_renamed_field_fails(self, texts):
        proto, wire = texts
        bad = self._edit(wire, '(2, "top_k", "int64", None),', '(2, "topk", "int64", None),')
        got = wire_contract.check_codec_messages(proto, bad)
        assert [v.message for v in got] == [
            "ScoreRequest field 2 is 'topk' in the codec but 'top_k' in scorer.proto"]
        assert got[0].line > 0

    def test_a_width_or_packing_change_fails(self, texts):
        proto, wire = texts
        bad = self._edit(wire, '(4, "priority", "repeated int64", None),',
                         '(4, "priority", "repeated int32", None),')
        msgs = [v.message for v in wire_contract.check_codec_messages(proto, bad)]
        assert any("'repeated int32' in the codec but 'repeated int64'" in m for m in msgs)
        bad = self._edit(wire, '(3, "cycle_ms", "double", None),',
                         '(3, "cycle_ms", "int64", None),')
        msgs = [v.message for v in wire_contract.check_codec_messages(proto, bad)]
        assert any("wire type varint against fixed64" in m for m in msgs)
        bad = self._edit(wire, '(1, "shape", "repeated int64", None),',
                         '(1, "shape", "int64", None),')
        msgs = [v.message for v in wire_contract.check_codec_messages(proto, bad)]
        assert any("length-delimited packed" in m for m in msgs)

    def test_a_wrong_message_type_fails(self, texts):
        proto, wire = texts
        bad = self._edit(wire, '(9, "terms", "message", TermTable),',
                         '(9, "terms", "message", GangTable),')
        msgs = [v.message for v in wire_contract.check_codec_messages(proto, bad)]
        assert msgs == ["SyncRequest.terms (field 9) decodes into GangTable but "
                        "scorer.proto declares TermTable"]

    def test_a_field_only_the_proto_has_fails(self, texts):
        proto, wire = texts
        grown = self._edit(proto, "message AssignRequest {\n  string snapshot_id = 1;",
                           "message AssignRequest {\n  string snapshot_id = 1;\n"
                           "  int64 budget_ms = 9;")
        msgs = [v.message for v in wire_contract.check_codec_messages(grown, wire)]
        assert msgs == ["AssignRequest.budget_ms (field 9) is missing from the codec: "
                        "its value would be dropped on decode and never written"]

    def test_a_message_only_one_side_has_fails(self, texts):
        proto, wire = texts
        grown = proto + "\nmessage PingRequest {\n  int64 stamp = 1;\n}\n"
        msgs = [v.message for v in wire_contract.check_codec_messages(grown, wire)]
        assert any("proto message PingRequest has no class" in m for m in msgs)
        extra = wire + ("\n\nclass PingRequest(Message):\n"
                        "    FIELDS = ((1, \"stamp\", \"int64\", None),)\n")
        msgs = [v.message for v in wire_contract.check_codec_messages(proto, extra)]
        assert msgs == ["codec class PingRequest has no message in scorer.proto"]

    def test_the_repo_pass_reads_the_codec(self, tmp_path):
        """A renumbered field in the tree's ``bridge/wire.py`` fails
        ``run_repo``'s wire-contract rule."""
        root = tmp_path / "repo"
        (root / "koordinator_tpu" / "bridge").mkdir(parents=True)
        (root / PORT / "bridge").mkdir(parents=True)
        (root / "koordinator_tpu" / "bridge" / "scorer.proto").write_text(
            read("koordinator_tpu", "bridge", "scorer.proto"))
        wire = read(PORT, "bridge", "wire.py")
        (root / PORT / "bridge" / "wire.py").write_text(wire)
        assert run_repo(root=str(root), rules=["wire-contract"]) == []
        (root / PORT / "bridge" / "wire.py").write_text(self._edit(
            wire, '(3, "deadline_ms", "int64", None),', '(8, "deadline_ms", "int64", None),'))
        got = run_repo(root=str(root), rules=["wire-contract"])
        assert any("AssignRequest.deadline_ms (field 3) is missing" in v.message for v in got)
        assert {v.path for v in got} == {f"{PORT}/bridge/wire.py"}
