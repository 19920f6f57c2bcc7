"""The paper's figure and table drivers on the port.

One module per table or figure (Table IV, figs 1–8), each a
``run()`` that renders its markdown into :data:`paper_data.RESULTS` and
returns ``(name, us_per_call, derived)`` rows; :mod:`.run` drives them and
the sweep smokes:

    python -m repro_torch.figures.run [--smoke|--live|--chaos] [--out DIR]
        [--results DIR] [--backend torch|numpy]

Figure 7's compiled layer is captured from the per-rank program's graph
(``core.hlo.scan_graph_collectives``).  The roofline table is not here
yet: it needs the dry-run records of the model stack.
"""
