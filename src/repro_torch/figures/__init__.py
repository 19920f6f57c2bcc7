"""The paper's figure and table drivers on the port.

One module per table or figure (Table IV, figs 1–6 and 8), each a
``run()`` that renders its markdown into :data:`paper_data.RESULTS` and
returns ``(name, us_per_call, derived)`` rows; :mod:`.run` drives them and
the sweep smokes:

    python -m repro_torch.figures.run [--smoke|--live|--chaos] [--out DIR]
        [--results DIR] [--backend torch|numpy]

Figure 7 (HLO against traced) and the roofline table are not here yet:
they need the HLO producer and the dry-run records of the model stack.
"""
