from fxtpu_torch.probes import main

main()
