"""Command-line runner: ``python -m metafast_jax.cli [-t tool] [options]``.

Mirrors the reference launcher (src/Runner.java, itmo Runner.java:191-208,
metafast.sh): ``-t`` selects a registered tool (default matrix-builder),
``--tools`` lists the registry, per-tool options come from the tool's
declared parameters, and the run is checkpointed under ``--work-dir``.
"""

from __future__ import annotations

import logging
import sys
import time
from pathlib import Path

from .tools import framework as fw
from .tools import ALL_TOOL_MODULES  # noqa: F401 — populates the registry

VERSION = "0.1.0"
DEFAULT_TOOL = "matrix-builder"


def _print_tools() -> None:
    print("Available tools:")
    for name, cls in fw.all_tools().items():
        print(f"  {name:28s} {cls.DESCRIPTION}")


def _print_help(tool_cls) -> None:
    t = tool_cls()
    print(f"Tool: {tool_cls.NAME}")
    print(tool_cls.DESCRIPTION)
    print("\nInput parameters:")
    for p in t.PARAMS:
        opts = (f"-{p.short} " if p.short else "") + f"--{p.name}"
        d = ("mandatory" if p.mandatory else
             f"default: {p.default_comment or p.default}")
        print(f"  {opts:36s} {p.description} [{d}]")
    print("\nLaunch options:")
    print("  -w --work-dir    working directory (default: workDir)")
    print("  -c --continue    continue the previous run (checkpointed steps)")
    print("     --force       rewrite the working directory")
    print("     --shards <n>  shard k-mer counting over n mesh devices")
    print("     --start NAME  start from this step")
    print("     --finish NAME stop after this step")
    print("  -v --verbose     enable debug output")
    print("  -h --help        this help")


def _setup_logging(workdir: Path, verbose: bool) -> logging.Logger:
    logger = logging.getLogger("metafast")
    logger.setLevel(logging.DEBUG if verbose else logging.INFO)
    logger.handlers.clear()
    con = logging.StreamHandler()
    con.setFormatter(logging.Formatter("%(asctime)s %(levelname)-5s %(message)s"))
    logger.addHandler(con)
    workdir.mkdir(parents=True, exist_ok=True)
    (workdir / "logs").mkdir(exist_ok=True)
    ts = time.strftime("%Y-%m-%d_%H-%M-%S")
    for fp in (workdir / "log", workdir / "logs" / f"log_{ts}"):
        fh = logging.FileHandler(fp, mode="a")
        fh.setFormatter(logging.Formatter("%(asctime)s %(levelname)-5s %(message)s"))
        logger.addHandler(fh)
    return logger


def parse_args(argv: list[str]):
    """Hand-rolled parser: tool params are dynamic, values may be lists."""
    tool_name = None
    opts: dict[str, list[str] | bool] = {}
    i = 0
    order: list[str] = []
    while i < len(argv):
        a = argv[i]
        if not a.startswith("-"):
            raise SystemExit(f"unexpected positional argument: {a}")
        key = a.lstrip("-")
        vals: list[str] = []
        i += 1
        while i < len(argv) and not (argv[i].startswith("-")
                                     and not _is_number(argv[i])):
            vals.append(argv[i])
            i += 1
        if key in ("t", "tool"):
            tool_name = vals[0] if vals else None
            continue
        opts[key] = vals if vals else True
        order.append(key)
    return tool_name, opts


def _is_number(s: str) -> bool:
    try:
        float(s)
        return True
    except ValueError:
        return False


def main(argv: list[str] | None = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)

    if not argv or argv in (["-h"], ["--help"]):
        print(f"Fast metagenome analysis toolkit, version {VERSION}\n")
        print("Usage:  python -m metafast_jax.cli [<Launch options>] "
              "[<Input parameters>]")
        print(f"Default tool: {DEFAULT_TOOL}; use --tools to list all tools, "
              f"-t <tool> -h for tool help.")
        return 0
    if "--version" in argv:
        print(f"metafast-jax version {VERSION}")
        return 0
    if "--tools" in argv:
        _print_tools()
        return 0
    if "--gui" in argv:
        from .gui import run_wizard
        return run_wizard([a for a in argv if a != "--gui"])

    tool_name, opts = parse_args(argv)
    tool_cls = fw.get_tool(tool_name or DEFAULT_TOOL)

    if opts.pop("h", None) or opts.pop("help", None):
        _print_help(tool_cls)
        return 0

    workdir = Path(str(_scalar(opts.pop("w", opts.pop("work-dir", ["workDir"])))))
    cont = bool(opts.pop("c", False) or opts.pop("continue", False))
    force = bool(opts.pop("force", False))
    start = opts.pop("start", None)
    finish = opts.pop("finish", None)
    verbose = bool(opts.pop("v", False) or opts.pop("verbose", False))
    shards = opts.pop("shards", None)
    if shards is not None:
        # shard k-mer counting over a device mesh (parallel/count.py);
        # the mesh analog of the reference's -p thread count
        import jax
        from . import api as _api
        from .parallel.count import make_mesh
        n = int(_scalar(shards))
        if n > len(jax.devices()):
            print(f"ERROR: --shards {n} exceeds available devices "
                  f"({len(jax.devices())})")
            return 1
        _api.set_default_mesh(make_mesh(n))
    opts.pop("p", None)
    opts.pop("available-processors", None)
    opts.pop("m", None)
    opts.pop("memory", None)
    opts.pop("ea", None)
    opts.pop("eta", None)

    logger = _setup_logging(workdir, verbose)
    ctx = fw.RunContext(workdir=workdir, cont=cont, force=force,
                        start=_scalar(start) if start else None,
                        finish=_scalar(finish) if finish else None,
                        verbose=verbose, logger=logger,
                        desc_files=[workdir / "output_description.txt"])

    tool = tool_cls()
    # map remaining options onto tool params (short or long)
    by_short = {p.short: p for p in tool.PARAMS if p.short}
    by_long = {p.name: p for p in tool.PARAMS}
    for key, val in opts.items():
        p = by_short.get(key) or by_long.get(key)
        if p is None:
            # the reference's commons-cli parser errors on unrecognized
            # options (Tool.java:626-659); a typo must not silently run
            # the whole pipeline with defaults
            logger.error("unknown option --%s for tool '%s' (see -t %s -h)",
                         key, tool.NAME, tool.NAME)
            return 1
        if p.type is bool:
            tool.set(p.name, True)
        elif p.multiple:
            tool.set(p.name, [p.type(v) for v in (val if isinstance(val, list) else [val])])
        else:
            v = val[0] if isinstance(val, list) else val
            tool.set(p.name, p.type(v))

    try:
        tool.run(ctx)
    except fw.ExecutionFailed as e:
        logger.error("%s", e)
        return 1
    except MemoryError:
        logger.error(_OOM_ADVICE)
        return 1
    except Exception as e:  # uncaught-failure UX parity (Tool.java:572-585)
        msg = str(e)
        if "RESOURCE_EXHAUSTED" in msg or "Out of memory" in msg:
            logger.error("device out of memory: %s", msg.splitlines()[0])
            logger.error(_OOM_ADVICE)
        else:
            logger.exception("unexpected failure in tool '%s'", tool.NAME)
            logger.error("this looks like a bug; the full traceback is in "
                         "%s", workdir / "log")
        return 1
    return 0


_OOM_ADVICE = (
    "the run exceeded available memory. Try: (1) shard the k-mer table "
    "over more devices with --shards N, (2) reduce the per-batch working "
    "set by splitting input files, or (3) raise the k-mer frequency "
    "threshold -b to shrink the table. (Reference equivalent: increase "
    "-m, Tool.java:532-564.)")


def _scalar(v):
    if isinstance(v, list):
        return v[0]
    return v


if __name__ == "__main__":
    raise SystemExit(main())
