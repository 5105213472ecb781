"""The mesh, abstract input specs and the dry run (the port of
``repro.launch``)."""
