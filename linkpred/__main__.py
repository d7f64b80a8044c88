"""`python -m linkpred` — the app launcher (reference `app.py:1-5`
spawns the Streamlit server; here it is the CLI)."""

from linkpred.cli import main

main()
