import sys

from sabench.run import main

sys.exit(main())
