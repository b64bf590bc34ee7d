"""plotpup-tpu: plot pileups from .clpy files (reference plotpuppy_CLI.py
counterpart, same flag surface)."""

from __future__ import annotations

import argparse
import logging
import pdb
import re
import sys
import traceback

import matplotlib as mpl
import matplotlib.pyplot as plt

from .._version import __version__
from ..io import load_pileup_df, load_pileup_df_list
from ..lib import numutils, puputils
from ..plotting import plot, plot_stripes

logger = logging.getLogger("coolpuppy_tpu")


def parse_args_plotpuppy():
    parser = argparse.ArgumentParser(
        formatter_class=argparse.ArgumentDefaultsHelpFormatter
    )
    parser.add_argument("--cmap", type=str, default="coolwarm")
    parser.add_argument(
        "--not_symmetric",
        "--not-symmetric",
        "--not_symmetrical",
        "--not-symmetrical",
        dest="not_symmetric",
        default=False,
        action="store_true",
    )
    parser.add_argument("--vmin", type=float, required=False)
    parser.add_argument("--vmax", type=float, required=False)
    parser.add_argument(
        "--scale", type=str, default="log", choices=["log", "linear"]
    )
    parser.add_argument(
        "--stripe",
        type=str,
        default=None,
        choices=["vertical_stripe", "horizontal_stripe", "corner_stripe"],
    )
    parser.add_argument("--stripe_sort", type=str, default="sum")
    parser.add_argument("--lineplot", default=False, action="store_true")
    parser.add_argument("--out_sorted_bedpe", type=str, default=None)
    parser.add_argument("--divide_pups", default=False, action="store_true")
    parser.add_argument("--font", type=str, default="DejaVu Sans")
    parser.add_argument("--font_scale", type=float, default=1)
    parser.add_argument("--cols", type=str)
    parser.add_argument("--rows", type=str)
    parser.add_argument("--col_order", type=lambda s: re.split(" |, ", s))
    parser.add_argument("--row_order", type=lambda s: re.split(" |, ", s))
    parser.add_argument("--colnames", type=str, nargs="+")
    parser.add_argument("--rownames", type=str, nargs="+")
    parser.add_argument(
        "--cbar_mode",
        type=str,
        default="single",
        choices=["single", "edge", "each"],
        help="One shared colorbar, one per row, or one per panel",
    )
    parser.add_argument(
        "--n_cols",
        type=int,
        default=0,
        help="Wrap panels into this many columns (0 = automatic layout)",
    )
    parser.add_argument(
        "--n_rows",
        type=int,
        default=0,
        help="Wrap panels into this many rows (0 = automatic layout)",
    )
    parser.add_argument("--query", type=str, default="", nargs="*")
    parser.add_argument("--norm_corners", type=int, default=0)
    parser.add_argument(
        "--no_score", action="store_true", default=False
    )
    parser.add_argument("--center", type=int, default=3)
    parser.add_argument("--ignore_central", type=int, default=3)
    parser.add_argument("--quaich", default=False, action="store_true")
    parser.add_argument("--dpi", type=int, default=300)
    parser.add_argument("--height", type=float, default=1)
    parser.add_argument(
        "--plot_ticks", action="store_true", default=False
    )
    parser.add_argument(
        "--output", "-o", "--outname", default="pup.pdf", type=str,
        dest="output",
    )
    parser.add_argument(
        "-l",
        "--log",
        dest="logLevel",
        choices=["DEBUG", "INFO", "WARNING", "ERROR", "CRITICAL"],
        default="INFO",
    )
    parser.add_argument(
        "--post_mortem", action="store_true", default=False
    )
    parser.add_argument("--input_pups", type=str, nargs="+", required=True)
    parser.add_argument("-v", "--version", action="version", version=__version__)
    return parser


def main(argv=None):
    args = parse_args_plotpuppy().parse_args(argv)
    logging.basicConfig(level=getattr(logging, args.logLevel))
    logger.setLevel(getattr(logging, args.logLevel))
    logger.debug(args)

    if args.post_mortem:

        def _excepthook(exc_type, value, tb):
            traceback.print_exception(exc_type, value, tb)
            print()
            pdb.pm()

        sys.excepthook = _excepthook

    mpl.rcParams["svg.fonttype"] = "none"
    mpl.rcParams["pdf.fonttype"] = 42

    if args.divide_pups:
        if len(args.input_pups) != 2:
            raise ValueError(
                "Need exactly two input pups when using --divide_pups"
            )
        pup1 = load_pileup_df(args.input_pups[0])
        pup2 = load_pileup_df(args.input_pups[1])
        pups = puputils.divide_pups(pup1, pup2)
    else:
        pups = load_pileup_df_list(
            args.input_pups,
            quaich=args.quaich,
            nice_metadata=True,
            skipstripes=not args.stripe,
        )

    if args.query:
        for q in args.query:
            pups = pups.query(q)

    if args.norm_corners > 0:
        pups["data"] = pups["data"].apply(
            numutils.norm_cis, i=int(args.norm_corners)
        )

    if not args.no_score:
        pups["score"] = pups.apply(
            puputils.get_score,
            center=args.center,
            ignore_central=args.ignore_central,
            axis=1,
        )
        score = "score"
    else:
        score = False

    if args.cols and args.col_order:
        pups[args.cols] = pups[args.cols].astype(str)
        pups = pups[pups[args.cols].isin(args.col_order)]
    if args.rows and args.row_order:
        pups[args.rows] = pups[args.rows].astype(str)
        pups = pups[pups[args.rows].isin(args.row_order)]

    if args.stripe_sort == "None":
        args.stripe_sort = None
    symmetric = not args.not_symmetric

    common = dict(
        cols=args.cols,
        rows=args.rows,
        col_order=args.col_order,
        row_order=args.row_order,
        vmin=args.vmin,
        vmax=args.vmax,
        sym=symmetric,
        cmap=args.cmap,
        scale=args.scale,
        height=args.height,
        font_scale=args.font_scale,
        plot_ticks=args.plot_ticks,
        colnames=args.colnames,
        rownames=args.rownames,
        cbar_mode=args.cbar_mode,
    )
    if args.stripe:
        plot_stripes(
            pups,
            stripe=args.stripe,
            stripe_sort=args.stripe_sort,
            out_sorted_bedpe=args.out_sorted_bedpe,
            lineplot=args.lineplot,
            **common,
        )
    else:
        plot(pups, score=score, n_cols=args.n_cols, n_rows=args.n_rows, **common)

    plt.savefig(args.output, bbox_inches="tight", dpi=args.dpi)
    logger.info(f"Saved output to {args.output}")
    return args.output


if __name__ == "__main__":
    main()
