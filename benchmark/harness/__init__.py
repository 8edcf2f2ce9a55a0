"""The benchmark's general code: finding files by name, the inputs made
from the seed, the drivers of each traffic kind, the checks of ``correct``,
the trace reduction, the FLOP count and the table of peaks."""
