"""App launcher — the reference's `app.py:1-5` spawns its Streamlit UI;
here the same entry point drops into the CLI (run `python app.py --help`)."""

import sys

from linkpred.cli import main

sys.exit(main(sys.argv[1:] if len(sys.argv) > 1 else ["compare"]))
