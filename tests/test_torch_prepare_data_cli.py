"""``python -m deep_vision_tpu_torch.cli.prepare_data`` against the JAX
package's CLI: the same subcommands, flags, choices and defaults, and
for every subcommand the same printed result and the same output tree,
byte for byte, on the synthetic layouts of tests/_torch_prep.py."""

import argparse
import os

import pytest

pytest.importorskip("PIL")

import _torch_prep as tp  # noqa: E402
from deep_vision_tpu.cli import prepare_data as jax_cli  # noqa: E402
from deep_vision_tpu_torch.cli import prepare_data as cli  # noqa: E402


class _Parsed(Exception):
    pass


def _reference_parser(monkeypatch) -> argparse.ArgumentParser:
    """The parser the reference's ``main`` builds (it has no builder of
    its own): caught at its ``parse_args``."""
    seen = {}

    def grab(self, *args, **kwargs):
        seen["parser"] = self
        raise _Parsed

    with monkeypatch.context() as m:
        m.setattr(argparse.ArgumentParser, "parse_args", grab)
        with pytest.raises(_Parsed):
            jax_cli.main([])
    return seen["parser"]


def _describe(parser) -> dict:
    """Every action's flags, kind, default, required, choices, type,
    nargs and const; subparsers by name (help texts left out)."""
    out = {}
    for a in parser._actions:
        if isinstance(a, argparse._SubParsersAction):
            out["<sub>"] = (a.dest, a.required,
                            {n: _describe(p) for n, p in a.choices.items()})
        else:
            out[a.dest] = (tuple(a.option_strings), type(a).__name__,
                           a.default, a.required,
                           tuple(a.choices) if a.choices else None,
                           getattr(a.type, "__name__", a.type), a.nargs,
                           a.const)
    return out


def test_parser_equals_reference(monkeypatch):
    got = _describe(cli.build_parser())
    want = _describe(_reference_parser(monkeypatch))
    assert got == want
    subs = got["<sub>"][2]
    assert sorted(subs) == sorted([
        "voc", "coco", "mpii", "imagenet", "imagenet-bboxes",
        "imagenet-flatten-train", "imagenet-flatten-val", "unpaired",
        "celeba"])
    for name in ("voc", "coco", "mpii", "imagenet"):
        assert subs[name]["store"][2] == "jpeg"
        assert subs[name]["store"][4] == ("jpeg", "raw")
    assert {n: subs[n]["resize"][2] for n in ("voc", "coco", "mpii",
                                              "imagenet")} == \
        {"voc": 416, "coco": 416, "mpii": 384, "imagenet": 256}
    assert subs["unpaired"]["num_shards"][2] == 8
    assert subs["celeba"]["attribute"][2] == "Male"


def test_parser_refuses_what_the_reference_refuses(monkeypatch, capsys):
    ref = _reference_parser(monkeypatch)
    for argv in ([], ["voc", "--out", "x"], ["imagenet", "--src", "s",
                                              "--labels", "l", "--out", "o",
                                              "--store", "png"]):
        codes = []
        for parser in (cli.build_parser(), ref):
            with pytest.raises(SystemExit) as e:
                parser.parse_args(argv)
            codes.append(e.value.code)
        assert codes == [2, 2]
    capsys.readouterr()


def _voc(src):
    return ["voc", "--voc-root", tp.voc_tree(src, split_lists=True),
            "--split", "val"]


def _coco(src):
    anno, images = tp.coco_tree(src)
    return ["coco", "--annotations", anno, "--images", images]


def _mpii(src):
    anno, images = tp.mpii_tree(src)
    return ["mpii", "--annotations", anno, "--images", images]


def _imagenet(src):
    flat = tp.imagenet_flat(os.path.join(src, "flat"))
    return ["imagenet", "--src", flat,
            "--labels", tp.metadata(os.path.join(src, "meta.txt"))]


def _imagenet_bboxed(src):
    xml_dir, synsets = tp.bbox_tree(src)
    csv = os.path.join(src, "boxes.csv")
    assert cli.main(["imagenet-bboxes", "--xml-dir", xml_dir, "--out-csv",
                     csv, "--synsets", synsets]) == 0
    flat = os.path.join(src, "flat")
    os.makedirs(flat)
    tp.save_image(os.path.join(flat, "n01440764_1.JPEG"), 40, 30, seed=3)
    return ["imagenet", "--src", flat, "--labels",
            tp.metadata(os.path.join(src, "meta.txt")), "--bbox-csv", csv]


def _bboxes(src):
    xml_dir, synsets = tp.bbox_tree(src)
    return ["imagenet-bboxes", "--xml-dir", xml_dir, "--synsets", synsets]


def _unpaired(src):
    da, db = tp.unpaired_dirs(src)
    return ["unpaired", "--dir-a", da, "--dir-b", db]


def _celeba(src):
    attr, imgs = tp.celeba_tree(src)
    return ["celeba", "--attr", attr, "--images", imgs, "--attribute",
            "Smiling"]


def _flatten_train(src):
    return ["imagenet-flatten-train", "--src", tp.raw_train_tree(src)]


def _flatten_val(src):
    raw, gt, synsets = tp.raw_val_flat(src)
    return ["imagenet-flatten-val", "--src", raw, "--ground-truth", gt,
            "--synsets", synsets]


#: (case, source builder, extra flags, output flags with {out})
CASES = [
    ("voc", _voc, [], ["--out", "{out}"]),
    ("voc_raw", _voc, ["--store", "raw", "--resize", "64"],
     ["--out", "{out}"]),
    ("coco", _coco, ["--num-shards", "2"], ["--out", "{out}"]),
    ("mpii_raw", _mpii, ["--store", "raw", "--resize", "48"],
     ["--out", "{out}"]),
    ("imagenet", _imagenet, ["--num-shards", "3"], ["--out", "{out}"]),
    ("imagenet_raw_bboxes", _imagenet_bboxed,
     ["--store", "raw", "--resize", "32", "--split", "val"],
     ["--out", "{out}"]),
    ("imagenet_bboxes", _bboxes, [], ["--out-csv", "{out}/boxes.csv"]),
    ("flatten_train", _flatten_train, [], ["--dest", "{out}"]),
    ("flatten_val", _flatten_val, [], ["--dest", "{out}"]),
    ("unpaired", _unpaired, ["--num-shards", "2"], ["--out", "{out}"]),
    ("celeba", _celeba, [], ["--out-a", "{out}/a", "--out-b", "{out}/b"]),
]


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_subcommand_output_equals_reference(tmp_path, capsys, case):
    _, build, extra, outs = case
    argv = build(str(tmp_path / "src"))
    shards = [] if argv[0].startswith("imagenet-") or argv[0] == "celeba" \
        else ["--num-workers", "1"]
    printed = {}
    for tag, main in (("mine", cli.main), ("ref", jax_cli.main)):
        out = tmp_path / tag
        out.mkdir()
        capsys.readouterr()
        assert main(argv + extra + shards
                    + [o.format(out=out) for o in outs]) == 0
        printed[tag] = capsys.readouterr().out
    assert printed["mine"] == printed["ref"]
    assert printed["mine"].startswith("prepared: ")
    tree = tp.assert_same_tree(tmp_path / "mine", tmp_path / "ref")
    assert tree  # every subcommand writes something
