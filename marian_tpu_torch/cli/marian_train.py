"""marian-train entry point of the port (reference:
src/command/marian_train.cpp). Runs on the card; ``--cpu-threads N``
runs on the CPU instead.

    python -m marian_tpu_torch.cli.marian_train --type transformer \\
        --train-sets train.src train.trg --vocabs v.yml v.yml \\
        --model model.npz
"""


def main(argv=None):
    from ..common.config_parser import parse_options
    opts = parse_options(argv, mode="training")
    from ..training.train import train_main
    train_main(opts)


if __name__ == "__main__":
    main()
