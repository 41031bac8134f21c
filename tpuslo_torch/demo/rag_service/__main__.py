from tpuslo_torch.demo.rag_service.server import main

raise SystemExit(main())
