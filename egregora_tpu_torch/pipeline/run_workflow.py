"""Run a workflow graph through the executor and save its audio.

    python -m egregora_tpu_torch.pipeline.run_workflow in.wav out.wav \\
        [--workflow PATH] [--device {cuda,cpu}]

The port of ``examples/run_workflow.py``: by default the graph is
``examples/audio_super_resolution_workflow.json`` (LoadAudio -> FlashSR
upscale -> Fat Llama spectral enhance, with previews), read in place;
node 1's ``path`` is set to ``in.wav``, the AUDIO output of the last node
in the file whose first output is AUDIO (the Fat Llama node there) is
written to ``out.wav``, then each node type's wall time is printed.  It runs on the card unless ``--device cpu``.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

EXAMPLE = Path(__file__).resolve().parents[2] / "examples" / "audio_super_resolution_workflow.json"


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="egregora_tpu_torch.pipeline.run_workflow")
    ap.add_argument("infile")
    ap.add_argument("outfile")
    ap.add_argument("--workflow", default=str(EXAMPLE))
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    return ap


def main(argv=None) -> int:
    from ..utils.wavio import write_audio
    from .executor import WorkflowExecutor

    args = build_parser().parse_args(argv)
    ex = WorkflowExecutor(device=args.device)
    results = ex.run(args.workflow, overrides={"1": {"path": args.infile}})
    order = [str(n["id"]) for n in json.loads(Path(args.workflow).read_text())["nodes"]]
    audio = [k for k in order if isinstance(results[k][0], dict) and "waveform" in results[k][0]]
    if not audio:
        raise SystemExit("run_workflow: no node of the graph returned AUDIO")
    nid = audio[-1]
    out = results[nid][0]
    write_audio(args.outfile, out["samples"], out["sample_rate"])
    print(f"wrote {args.outfile} @ {out['sample_rate']} Hz (node {nid})")
    for node, stats in ex.timing_summary().items():
        print(f"  {node}: {stats['total_s']:.2f}s over {int(stats['calls'])} call(s)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
