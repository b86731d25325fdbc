"""Traffic generators, one module a kind of data: a traffic file
(``traffic/<name>.json``) names its ``generator``, and
``generators/<generator>.py`` makes the run's batches from the file's
parameters (``traffic.py`` finds it)."""
