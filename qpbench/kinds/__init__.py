"""Traffic kinds: ``<kind>.py`` holds ``Stream``, a subclass of
``workload.Stream`` that gives a cell's calls in order. A traffic mix
(``traffic/<cell>.json``) names its kind and its parameters."""
