"""Host milliseconds per traced call inside the program's
``decode.route`` (extension routing, the device check) and
``decode.assemble`` (concat_batches and the permutation gather) spans."""

from h100bench import program


def read(run):
    return program.host_ms(run, "decode.route", "decode.assemble")
