"""Plain-torch glue: the ROM's own device milliseconds a traced batch, the
union of the device rows launched inside the port's ``qublas.rom`` spans
(``anus.QTable``'s mask, index, gather and cast), wherever the card ran
them; part of ``glue_device_ms`` (device trace, none without such a span
or where the rows cannot be paired with their launches)."""

from gpubench import spans


def read(run):
    return spans.device_ms(run, "qublas.rom")
