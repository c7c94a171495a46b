"""One config module per assigned architecture (exact public specs), copies
of the reference's ``repro/configs``: data only, shared by no import."""
