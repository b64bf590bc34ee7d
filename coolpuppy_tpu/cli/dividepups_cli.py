"""dividepups-tpu: divide two pileups (reference divide_pups_CLI.py)."""

from __future__ import annotations

import argparse
import logging

from .._version import __version__
from ..io import load_pileup_df, save_pileup_df
from ..lib.puputils import divide_pups


def parse_args_divide_pups():
    parser = argparse.ArgumentParser(
        formatter_class=argparse.ArgumentDefaultsHelpFormatter
    )
    parser.add_argument(
        "input_pups", type=str, nargs="+", help="Two pileups to divide"
    )
    parser.add_argument("-v", "--version", action="version", version=__version__)
    parser.add_argument("-o", "--outname", default="auto", type=str)
    return parser


def main(argv=None):
    args = parse_args_divide_pups().parse_args(argv)
    logging.info(args)
    if len(args.input_pups) != 2:
        raise ValueError("Need exactly two input pups")
    pup1 = load_pileup_df(args.input_pups[0])
    pup2 = load_pileup_df(args.input_pups[1])
    pups = divide_pups(pup1, pup2)
    if args.outname == "auto":
        outname = f"{args.input_pups[0]}_over_{args.input_pups[1]}.clpy"
    else:
        outname = args.outname
    save_pileup_df(outname, pups)
    logging.info(f"Saved output to {outname}")
    return outname


if __name__ == "__main__":
    main()
