"""Seconds from the process's start to the window's: imports, weights and
inputs, the model's build, kernel builds where none is cached, warm-up."""


def read(record):
    return record["setup_s"]
