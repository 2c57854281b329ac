"""One driver per traffic kind (``portbench/traffic/<mix>.json``'s
``"driver"``)."""
