from tpuslo_torch.demo.vectordb.server import main

raise SystemExit(main())
