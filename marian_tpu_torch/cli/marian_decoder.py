"""marian-decoder entry point of the port (reference:
src/command/marian_decoder.cpp). Runs on the card; ``--cpu-threads N``
runs on the CPU instead.

    python -m marian_tpu_torch.cli.marian_decoder --models model.npz \\
        --vocabs v.yml v.yml --beam-size 6 < input.txt
"""


def main(argv=None):
    from ..common.config_parser import parse_options
    opts = parse_options(argv)
    from ..translator.translator import translate_main
    translate_main(opts)


if __name__ == "__main__":
    main()
