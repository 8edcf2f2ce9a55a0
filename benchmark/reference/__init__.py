"""Plain references of the benchmark's configurations: ``<config>.py`` is
found by the configuration's name; the shared plain pieces sit beside."""
