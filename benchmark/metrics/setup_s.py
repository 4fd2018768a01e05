"""setup_s: seconds from the process's start to the window's start: imports,
the card's start, kernel builds on a first run, weights from the seed, the
program's set-up and the warm-up of every shape the traffic uses."""


def read(record):
    return record.setup_s
